"""DataState: the explicit, checkpointable iteration cursor.

Counterpart of deeperspeed_tpu/datapipe/state.py, the same fields and
the same dict form, so a checkpoint of either package names the same
position in the same batch stream:

  * ``epoch``      — which counter-based permutation is in effect;
  * ``cursor``     — samples already consumed from this epoch's order;
  * ``offset``     — tokens already consumed from the (EOS-augmented)
    document at the cursor, when sequence packing split that document
    at a batch boundary; 0 otherwise;
  * ``step``       — global batches produced (drives the curriculum and
    the batch-size schedule, so prefetched batches are shaped for the
    step that will consume them);
  * ``samples``    — lifetime samples consumed;
  * ``seed``       — the shuffle seed the stream was built with;
  * ``fingerprint``— hash of the current epoch's order and the dataset
    identity, checked at restore so a changed corpus or seed is loud.

The state advances only when a batch is handed to the step loop, never
when the prefetcher merely produces it: a checkpoint taken at a step
boundary points at exactly the first batch the resumed run consumes,
however many batches sat staged in the queue.
"""

import dataclasses

__all__ = ["DataState"]


@dataclasses.dataclass(frozen=True)
class DataState:
    epoch: int = 0
    cursor: int = 0
    step: int = 0
    samples: int = 0
    seed: int = 0
    fingerprint: str = ""
    offset: int = 0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "DataState":
        # unknown keys are dropped and missing keys default, so a state
        # written before a field existed (``offset``) restores cleanly
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in (d or {}).items() if k in known})
