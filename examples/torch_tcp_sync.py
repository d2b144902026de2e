"""Two networked replicas of the PyTorch port converging over real TCP δ
sync.

The twin of examples/tcp_sync.py.  The reference simulates exchange as a
direct method call (awset_test.go:16-17); this is the same anti-entropy
as an actual protocol: each port ``Node`` serves push-pull δ sync
(net/peer.py), payloads are the compact varint wire format, and
convergence is checked on members and clocks.

    python examples/torch_tcp_sync.py                # on the GPU
    python examples/torch_tcp_sync.py --device cpu   # plain versions

Without a GPU the default ``--device cuda`` raises, as every port entry
does.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    import numpy as np

    from go_crdt_playground_tpu_torch.net.peer import Node

    with Node(actor=0, num_elements=64, num_actors=2,
              device=args.device) as alice, \
            Node(actor=1, num_elements=64, num_actors=2,
                 device=args.device) as bob:
        addr = bob.serve()
        alice.add(1, 2, 3)
        bob.add(3, 4)
        alice.delete(2)

        # ONE push-pull exchange converges both ends: the dialer ships
        # its δ against the peer's advertised vv and applies the peer's
        # δ back on the same connection.
        stats = alice.sync_with(addr)
        print(f"push-pull: sent {stats.bytes_sent}B "
              f"received {stats.bytes_received}B")

        members_a = set(alice.members().tolist())
        members_b = set(bob.members().tolist())
        print("alice members:", sorted(members_a))
        print("bob members:  ", sorted(members_b))
        assert members_a == members_b == {1, 3, 4}, "must converge"
        assert np.array_equal(alice.vv(), bob.vv()), "clocks must join"
        print(f"converged over TCP on {alice.device}: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
