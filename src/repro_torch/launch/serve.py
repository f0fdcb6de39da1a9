"""Serving launcher — twin of ``repro/launch/serve.py``.

* ``--workload lm`` — the continuous-batching LM server
  (``repro_torch.serve.serving``) over a ported arch: ``qwen3-14b`` (the
  dense family, the default, as in the reference) or ``mamba2-2.7b`` (the
  SSM family).  ``--smoke`` serves the reduced config; ``--device cpu``
  runs on the CPU through the kernels' plain versions.

      PYTHONPATH=src python -m repro_torch.launch.serve --workload lm --arch qwen3-14b
      PYTHONPATH=src python -m repro_torch.launch.serve --workload lm --arch qwen3-14b --smoke --device cpu

* ``--workload agg`` — the aggregate-serving layer; not ported yet
  (ROADMAP A9): it exits with that message.
"""
from __future__ import annotations

import argparse
import time


def make_requests(vocab: int, n: int, max_new: int) -> list:
    """The launcher's requests: prompts of 3 to 11 tokens drawn from
    ``numpy.random.default_rng(0)``, as the reference draws them."""
    import numpy as np

    from repro_torch.serve.serving import Request

    rng = np.random.default_rng(0)
    return [Request(rid=i,
                    prompt=rng.integers(0, vocab,
                                        rng.integers(3, 12)).tolist(),
                    max_new=max_new)
            for i in range(n)]


def serve_requests(lm, params, reqs, *, slots: int, max_len: int) -> dict:
    """Serve ``reqs`` through one ``Server``; the wall seconds (host clock,
    ending in a device sync on the card), the steps and the new tokens."""
    import torch

    from repro_torch.serve.serving import Server

    server = Server(lm, params, slots=slots, max_len=max_len)
    for r in reqs:
        server.submit(r)
    t0 = time.perf_counter()
    steps = server.run()
    if lm.device.type == "cuda":
        torch.cuda.synchronize()
    return {"seconds": time.perf_counter() - t0, "steps": steps,
            "tokens": sum(len(r.out) for r in reqs),
            "done": sum(r.done for r in reqs)}


def _serve_lm(args) -> dict:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import LM
    from repro_torch.models.layers import reference_numerics

    reference_numerics()
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    lm = LM(cfg, q_chunk=32 if args.smoke else 1024,
            kv_chunk=32 if args.smoke else 1024,
            ssd_chunk=8 if args.smoke else 128, device=args.device)
    params = lm.init(torch.Generator(device=lm.device).manual_seed(0))
    reqs = make_requests(cfg.vocab, args.requests, args.max_new)
    res = serve_requests(lm, params, reqs, slots=args.slots,
                         max_len=args.max_len)
    print(f"{res['done']}/{len(reqs)} requests, {res['tokens']} tokens, "
          f"{res['tokens'] / res['seconds']:.1f} tok/s")
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", choices=("agg", "lm"), default="agg")
    ap.add_argument("--arch", default="qwen3-14b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device; default: the GPU (raises without "
                         "CUDA)")
    args = ap.parse_args(argv)
    if args.workload != "lm":
        raise SystemExit("--workload agg (the aggregate-serving layer) is "
                         "not ported yet: it waits for ROADMAP A9; use "
                         "--workload lm")
    _serve_lm(args)


if __name__ == "__main__":
    main()
