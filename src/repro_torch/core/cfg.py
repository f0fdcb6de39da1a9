"""Control Flow Graph construction (paper §3.2, Figure 3).

Each statement is its own basic block, exactly as in the paper's Figure 3.
The cursor-loop skeleton is modeled faithfully:

    entry -> pre... -> FETCH0 -> WHILE hdr -> body... -> FETCHn -> WHILE hdr
                                      |(false)
                                      v
                                    post... -> exit

The FETCH nodes *define* the fetch variables; the WHILE header *uses* the
implicit ``@@FETCH_STATUS``.  Parameters are defined at the entry node so
that reaching-definitions distinguishes outer definitions from in-loop
definitions (Eq. 2/3 of the paper).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

from .loop_ir import (Assign, CursorLoop, If, InsertLocal, Program, Stmt,
                      expr_vars, stmt_defs, stmt_uses)

FETCH_STATUS = "@@FETCH_STATUS"


@dataclass
class Node:
    nid: int
    kind: str               # entry|exit|assign|if|insert|fetch|while
    stmt: Optional[Stmt]
    defs: frozenset[str]
    uses: frozenset[str]
    in_loop_body: bool = False
    succs: list[int] = field(default_factory=list)
    preds: list[int] = field(default_factory=list)

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"<{self.nid}:{self.kind} defs={sorted(self.defs)} uses={sorted(self.uses)}>"


class CFG:
    def __init__(self) -> None:
        self.nodes: list[Node] = []
        self.entry: int = -1
        self.exit: int = -1
        # program points of interest for Aggify:
        self.loop_header: int = -1
        self.loop_exit_point: int = -1   # first node after the loop (post/exit)
        self.body_nodes: set[int] = set()
        self.fetch_nodes: set[int] = set()

    def add(self, kind: str, stmt: Optional[Stmt] = None,
            defs: Sequence[str] = (), uses: Sequence[str] = (),
            in_loop_body: bool = False) -> int:
        n = Node(len(self.nodes), kind, stmt, frozenset(defs), frozenset(uses),
                 in_loop_body)
        self.nodes.append(n)
        return n.nid

    def edge(self, a: int, b: int) -> None:
        if b not in self.nodes[a].succs:
            self.nodes[a].succs.append(b)
            self.nodes[b].preds.append(a)

    # -- construction -------------------------------------------------------

    @staticmethod
    def of_program(prog: Program) -> "CFG":
        if not isinstance(prog.loop, CursorLoop):
            raise TypeError("CFG.of_program expects a Program with a CursorLoop; "
                            "FOR loops are not ported yet")
        g = CFG()
        # Entry defines the parameters (their values reach every use).
        g.entry = g.add("entry", defs=prog.params)
        frontier = [g.entry]

        def chain(stmts: Sequence[Stmt], frontier: list[int],
                  in_body: bool) -> list[int]:
            for s in stmts:
                frontier = _emit(g, s, frontier, in_body)
            return frontier

        frontier = chain(prog.pre, frontier, False)

        loop = prog.loop
        fvars = set(loop.fetch_vars) | {FETCH_STATUS}
        f0 = g.add("fetch", defs=fvars, uses=())
        g.fetch_nodes.add(f0)
        for p in frontier:
            g.edge(p, f0)

        hdr = g.add("while", uses=[FETCH_STATUS])
        g.loop_header = hdr
        g.edge(f0, hdr)

        body_start = len(g.nodes)
        body_frontier = chain(loop.body, [hdr], True)
        fn = g.add("fetch", defs=fvars, uses=(), in_loop_body=True)
        g.fetch_nodes.add(fn)
        for p in body_frontier:
            g.edge(p, fn)
        g.edge(fn, hdr)          # back edge
        g.body_nodes = set(range(body_start, len(g.nodes)))

        # loop exit -> post -> exit
        post_frontier = chain(prog.post, [hdr], False)
        g.exit = g.add("exit", uses=prog.returns)
        for p in post_frontier:
            g.edge(p, g.exit)
        # first node after the header on the false edge:
        g.loop_exit_point = g.nodes[hdr].succs[-1] if prog.post else g.exit
        return g


def _emit(g: CFG, s: Stmt, frontier: list[int], in_body: bool) -> list[int]:
    if isinstance(s, Assign):
        n = g.add("assign", s, defs=stmt_defs(s), uses=stmt_uses(s),
                  in_loop_body=in_body)
        for p in frontier:
            g.edge(p, n)
        return [n]
    if isinstance(s, InsertLocal):
        n = g.add("insert", s, defs=stmt_defs(s), uses=stmt_uses(s),
                  in_loop_body=in_body)
        for p in frontier:
            g.edge(p, n)
        return [n]
    if isinstance(s, If):
        c = g.add("if", s, uses=expr_vars(s.cond), in_loop_body=in_body)
        for p in frontier:
            g.edge(p, c)
        t_frontier = [c]
        for ts in s.then:
            t_frontier = _emit(g, ts, t_frontier, in_body)
        e_frontier = [c]
        for es in s.orelse:
            e_frontier = _emit(g, es, e_frontier, in_body)
        # merge point is implicit: both frontiers feed the next statement.
        # (when orelse is empty, e_frontier == [c]: the false edge.)
        return t_frontier + e_frontier
    raise TypeError(type(s))
