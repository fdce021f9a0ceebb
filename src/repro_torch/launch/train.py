"""Training launcher (``repro/launch/train.py``): ``python -m
repro_torch.launch.train --arch olmo-1b --steps 50 --supervise --fail-at 12``.

End-to-end training of the reduced LM configs with the production
machinery: the deterministic ``TokenStream`` (batch = f(seed, step)),
AdamW, checkpoint/restart supervision and failure injection.  The model
trains on the card unless ``--device`` names another device.

As in the reference:
  * ``--reduced`` is on whatever the command line says (``store_true``
    with ``default=True``), so the launcher trains the reduced spec;
  * the optimiser state is ``adamw_init(params)`` with the default
    ``AdamWConfig``, whatever the spec's own optimiser settings;
  * ``--devices`` and ``--compress-grads`` are parsed and change nothing
    here: the reference's ``--devices`` only sets XLA's host-device count
    (its train step runs on one device), and its ``--compress-grads`` is
    read by no code.

The train step updates its state in place, so the first step works on a
copy of the initial state: a restart from scratch then finds it as it was.
A resumed run is bit-exact: the final state equals an uninterrupted run's.
``main`` returns the final state.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--supervise", action="store_true")
    ap.add_argument("--fail-at", type=int, action="append", default=[])
    ap.add_argument("--devices", type=int, default=0,
                    help="the reference's host-device count (no effect)")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    import torch

    from ..checkpoint import CheckpointManager
    from ..configs import get_arch
    from ..core.types import resolve_device
    from ..data import TokenStream
    from ..ft import Supervisor
    from ..training.optimizer import adamw_init, tree_map

    dev = resolve_device(args.device)
    spec = get_arch(args.arch)
    if spec.family != "lm":
        raise SystemExit("train.py drives LM archs; see serve.py for others")
    if args.reduced:
        spec = spec.reduced()
    shape = spec.shapes()["train_4k"]
    cfg = spec.cfg
    b, s = shape.dims["batch"], shape.dims["seq"]
    stream = TokenStream(vocab=cfg.vocab, batch=b, seq=s, seed=args.seed)

    from ..models.transformer import init_params

    params = init_params(torch.Generator(device=dev).manual_seed(args.seed),
                         cfg, device=dev)
    state = {"params": params, "opt": adamw_init(params)}
    step = spec.make_step(shape)

    losses = []

    def step_fn(state, t):
        if t == 0:
            state = tree_map(torch.clone, state)
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in stream.batch_at(t).items()}
        state, out = step(state, batch)
        losses.append(float(out["loss"]))
        if t % 10 == 0:
            print(f"step {t:4d} loss {losses[-1]:.4f}", flush=True)
        return state

    t0 = time.time()
    if args.supervise:
        mgr = CheckpointManager(args.ckpt_dir)
        sup = Supervisor(mgr, checkpoint_every=args.ckpt_every)
        state, info = sup.run(
            state, step_fn, args.steps, device=dev,
            fail_at={t: 1 for t in args.fail_at},
            log=lambda m: print(f"[supervisor] {m}", flush=True),
        )
        print(f"done: restarts={info['restarts']}")
    else:
        for t in range(args.steps):
            state = step_fn(state, t)
    dt = time.time() - t0
    print(
        f"trained {args.steps} steps of {args.arch} in {dt:.1f}s "
        f"(final loss {losses[-1]:.4f}, first {losses[0]:.4f})"
    )
    return state


if __name__ == "__main__":
    main()
