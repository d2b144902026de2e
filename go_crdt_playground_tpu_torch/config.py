"""Framework configuration: static shapes in one small frozen dataclass
threaded through the state constructors."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Config:
    """Static-shape configuration.

    Attributes:
      num_replicas: replica axis ``R``, how many CRDT replicas are packed
        into one batched state.
      num_elements: element-universe axis ``E``, dictionary-encoded
        element ids ``0..E-1``.
      num_actors: actor axis ``A``, the version vector length.
      mesh_shape: (replica_shards, element_shards) of the mesh that
        ``make_mesh`` builds; None: every slot on the replica axis.

    Clocks and counters are uint32 (stored as int32 bits).  Semantics
    switches are arguments of the functions that use them
    (``strict_reference_semantics``, ``with_trace``).
    """

    num_replicas: int = 2
    num_elements: int = 16
    num_actors: int = 2
    mesh_shape: Optional[Tuple[int, int]] = None

    def __post_init__(self) -> None:
        if self.num_replicas < 1 or self.num_elements < 1 or self.num_actors < 1:
            raise ValueError("num_replicas/num_elements/num_actors must be >= 1")

    def init_awset(self, actors=None, device="cuda"):
        from go_crdt_playground_tpu_torch.models import awset

        return awset.init(self.num_replicas, self.num_elements,
                          self.num_actors, actors, device=device)

    def init_awset_delta(self, actors=None, device="cuda"):
        from go_crdt_playground_tpu_torch.models import awset_delta

        return awset_delta.init(self.num_replicas, self.num_elements,
                                self.num_actors, actors, device=device)

    def element_dict(self, values=None):
        from go_crdt_playground_tpu_torch.utils.codec import ElementDict

        return ElementDict(capacity=self.num_elements, values=values)

    def make_mesh(self, devices=None, device="cuda"):
        """The (replica_shards, element_shards) mesh of ``mesh_shape``
        over ``devices``, by default ``mesh.take_devices`` of ``device``:
        distinct cards (raising with too few), or every slot on a device
        named with its index or ``"cpu"``."""
        from go_crdt_playground_tpu_torch.parallel import mesh

        if devices is None:
            shape = self.mesh_shape
            devices = mesh.take_devices(
                None if shape is None else shape[0] * shape[1], device)
        return mesh.make_mesh(self.mesh_shape, devices=devices)


# The conformance anchor config: 3 replicas x 16 elements, each replica
# its own actor.
REFERENCE_CONFIG = Config(num_replicas=3, num_elements=16, num_actors=3)
