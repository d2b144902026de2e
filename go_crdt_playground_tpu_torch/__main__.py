"""Command line: a replica fleet converging by anti-entropy gossip.

  python -m go_crdt_playground_tpu_torch gossip [--replicas N] [--delta]
      [--schedule dissemination|ring|random|butterfly] [--drop-rate P]
      [--seed S] [--device cuda|cpu]

Every replica adds one element of a 128-element universe, then the
fleet gossips until every replica agrees on (membership, VV); the verb
prints the round count and the digest.  The device defaults to CUDA.
"""

from __future__ import annotations

import argparse
import sys


def _cmd_gossip(num_replicas: int, delta: bool = False,
                drop_rate: float = 0.0, seed: int = 0,
                schedule: str = "dissemination", device="cuda") -> int:
    import numpy as np

    from go_crdt_playground_tpu_torch._u32 import widen
    from go_crdt_playground_tpu_torch.config import Config
    from go_crdt_playground_tpu_torch.models import awset, awset_delta
    from go_crdt_playground_tpu_torch.parallel import collectives, gossip

    cfg = Config(num_replicas=num_replicas, num_elements=128,
                 num_actors=num_replicas)
    R, E = cfg.num_replicas, cfg.num_elements
    mod = awset_delta if delta else awset
    state = (cfg.init_awset_delta(device=device) if delta
             else cfg.init_awset(device=device))
    rng = np.random.default_rng(0)
    for r in range(R):             # every replica adds a private slice
        state = mod.add_element(state, r, rng.integers(E))
    rounds, state = gossip.rounds_to_convergence(
        state, seed=seed, drop_rate=drop_rate, delta=delta,
        schedule=schedule)
    digest = collectives.state_digest(state.present, state.vv)
    kind = "delta" if delta else "full-state"
    drop = f" under {drop_rate:.0%} drop" if drop_rate > 0.0 else ""
    print(f"{R} replicas ({kind} gossip{drop}) converged in {rounds} "
          f"{schedule} rounds; digest={int(widen(digest[0])):#x}")
    return 0


def _rate(text: str) -> float:
    v = float(text)
    if not 0.0 <= v < 1.0:
        raise argparse.ArgumentTypeError(
            f"drop rate must be in [0, 1), got {v} (at 1.0 every "
            "exchange is lost and the fleet can never converge)")
    return v


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="go_crdt_playground_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    g = sub.add_parser("gossip")
    g.add_argument("--replicas", type=int, default=64)
    g.add_argument("--delta", action="store_true",
                   help="payload-compressed delta gossip (v2 semantics)")
    g.add_argument("--drop-rate", type=_rate, default=0.0,
                   help="per-replica exchange loss probability per round")
    g.add_argument("--seed", type=int, default=0,
                   help="seed of the drop masks and random pairings")
    g.add_argument("--schedule", default="dissemination",
                   choices=("dissemination", "ring", "random", "butterfly"),
                   help="anti-entropy pairing schedule per round")
    g.add_argument("--device", default="cuda",
                   help="torch device of the fleet (default cuda; cpu runs "
                        "the kernels' plain versions)")
    args = p.parse_args(argv)
    return _cmd_gossip(args.replicas, args.delta, args.drop_rate,
                       args.seed, args.schedule, args.device)


if __name__ == "__main__":
    sys.exit(main())
