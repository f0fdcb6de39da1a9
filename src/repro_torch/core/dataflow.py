"""Data flow analysis (paper §3.2): reaching definitions, live variables,
UD/DU chains — the textbook iterative fixpoint formulations [Aho et al.;
Khedker et al.], operating on the per-statement CFG of ``cfg.py``.

These are the *inputs* to Algorithm 1 (``A(L, R, UD, DU)`` in the paper).
"""
from __future__ import annotations

from dataclasses import dataclass

from .cfg import CFG

Def = tuple[int, str]  # (node id, variable)


@dataclass
class DataflowResult:
    cfg: CFG
    reach_in: list[frozenset[Def]]
    reach_out: list[frozenset[Def]]
    live_in: list[frozenset[str]]
    live_out: list[frozenset[str]]
    ud: dict[tuple[int, str], frozenset[int]]   # (use node, var) -> def nodes
    du: dict[tuple[int, str], frozenset[int]]   # (def node, var) -> use nodes

    # -- queries used by Algorithm 1 ---------------------------------------

    def defs_reaching_use(self, node: int, var: str) -> frozenset[int]:
        return self.ud.get((node, var), frozenset())

    def live_at(self, node: int) -> frozenset[str]:
        """Variables live at the entry of ``node`` (a program point)."""
        return self.live_in[node]


def analyze(cfg: CFG) -> DataflowResult:
    n = len(cfg.nodes)

    # ---- reaching definitions (forward, union) ----------------------------
    gen: list[set[Def]] = [set() for _ in range(n)]
    kill_vars: list[frozenset[str]] = [frozenset() for _ in range(n)]
    for node in cfg.nodes:
        gen[node.nid] = {(node.nid, v) for v in node.defs}
        kill_vars[node.nid] = node.defs

    reach_in: list[set[Def]] = [set() for _ in range(n)]
    reach_out: list[set[Def]] = [set(gen[i]) for i in range(n)]
    changed = True
    while changed:
        changed = False
        for node in cfg.nodes:
            i = node.nid
            rin: set[Def] = set()
            for p in node.preds:
                rin |= reach_out[p]
            rout = gen[i] | {d for d in rin if d[1] not in kill_vars[i]}
            if rin != reach_in[i] or rout != reach_out[i]:
                reach_in[i], reach_out[i] = rin, rout
                changed = True

    # ---- liveness (backward, union) ---------------------------------------
    live_in: list[set[str]] = [set() for _ in range(n)]
    live_out: list[set[str]] = [set() for _ in range(n)]
    changed = True
    while changed:
        changed = False
        for node in reversed(cfg.nodes):
            i = node.nid
            lout: set[str] = set()
            for s in node.succs:
                lout |= live_in[s]
            lin = set(node.uses) | (lout - set(node.defs))
            if lin != live_in[i] or lout != live_out[i]:
                live_in[i], live_out[i] = lin, lout
                changed = True

    # ---- UD / DU chains ----------------------------------------------------
    ud: dict[tuple[int, str], frozenset[int]] = {}
    du_acc: dict[tuple[int, str], set[int]] = {}
    for node in cfg.nodes:
        for v in node.uses:
            defs = frozenset(d for (d, dv) in reach_in[node.nid] if dv == v)
            ud[(node.nid, v)] = defs
            for d in defs:
                du_acc.setdefault((d, v), set()).add(node.nid)
    du = {k: frozenset(v) for k, v in du_acc.items()}

    return DataflowResult(
        cfg=cfg,
        reach_in=[frozenset(s) for s in reach_in],
        reach_out=[frozenset(s) for s in reach_out],
        live_in=[frozenset(s) for s in live_in],
        live_out=[frozenset(s) for s in live_out],
        ud=ud,
        du=du,
    )
