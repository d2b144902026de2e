"""Quickstart on the PyTorch port: the reference's add-wins semantics,
spec to CUDA kernel.

The twin of examples/quickstart.py for a switching user's first session
on the port: write the scenario from
TestAWSetConcurrentAddWinsOverDelete (reference awset_test.go:85-122)
against the port's executable spec, then run the SAME ops through the
packed tensor path — pack, the one-row merge kernel (K3,
``ops/merge.merge_one_into``; its plain version on the CPU), unpack,
byte-equal canonical rendering.

Run from the repo root:

    python examples/torch_quickstart.py                # on the GPU
    python examples/torch_quickstart.py --device cpu   # plain versions

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

    from go_crdt_playground_tpu_torch.models import awset
    from go_crdt_playground_tpu_torch.models.spec import AWSet, VersionVector
    from go_crdt_playground_tpu_torch.ops.merge import merge_one_into
    from go_crdt_playground_tpu_torch.utils import codec

    # --- the reference scenario on the executable spec ------------------
    a = AWSet(actor=0, version_vector=VersionVector([0, 0]))
    b = AWSet(actor=1, version_vector=VersionVector([0, 0]))
    a.add("Anne", "Bob")
    b.merge(a)          # B observes both adds
    a.del_("Bob")       # A deletes Bob...
    b.add("Bob")        # ...while B concurrently re-adds him
    a.merge(b)
    b.merge(a)
    print("spec A:", a, sep="\n")
    assert a.sorted_values() == b.sorted_values() == ["Anne", "Bob"], \
        "concurrent add must win over delete"

    # --- the same ops through the packed tensor path --------------------
    dictionary = codec.ElementDict(capacity=4)
    state = awset.from_arrays(codec.pack_awsets([a, b], dictionary, 2),
                              device=args.device)
    state, _ = merge_one_into(state, 0, state, 1)   # K3 on the card
    rendered = codec.render_packed(awset.to_arrays(state), dictionary)
    print(f"packed replica 0 ({state.vv.device}):", rendered[0], sep="\n")
    assert rendered[0] == str(a), "canonical renderings must be byte-equal"
    print("spec and kernel agree byte-for-byte: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
