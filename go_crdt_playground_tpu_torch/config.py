"""Framework configuration: static shapes in one small frozen dataclass
threaded through the state constructors."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Config:
    """Static-shape configuration.

    Attributes:
      num_replicas: replica axis ``R``, how many CRDT replicas are packed
        into one batched state.
      num_elements: element-universe axis ``E``, dictionary-encoded
        element ids ``0..E-1``.
      num_actors: actor axis ``A``, the version vector length.

    Clocks and counters are uint32 (stored as int32 bits).  Semantics
    switches are arguments of the functions that use them
    (``strict_reference_semantics``, ``with_trace``).
    """

    num_replicas: int = 2
    num_elements: int = 16
    num_actors: int = 2

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


# The conformance anchor config: 3 replicas x 16 elements, each replica
# its own actor.
REFERENCE_CONFIG = Config(num_replicas=3, num_elements=16, num_actors=3)
