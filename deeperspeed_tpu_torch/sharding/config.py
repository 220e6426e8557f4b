"""The ``"mesh"`` config block: one place where a run chooses its layout.

Counterpart of deeperspeed_tpu/sharding/config.py, this package's own copy:
the same keys, defaults, inference of one ``-1`` extent and errors. The
block maps onto the canonical named mesh ``dp x fsdp x tp x sp`` that
:mod:`.mesh` builds over ``torch.distributed`` ranks:

.. code-block:: json

    {"mesh": {"dp": 2, "fsdp": 4, "tp": 1, "sp": 1}}

* ``dp``    -- pure data parallelism: params replicated, batch sharded.
* ``fsdp``  -- the ZeRO axis: batch sharded and (per ``zero_optimization
  .stage``) the fp32 master and optimizer moments sharded over it.
* ``tp``, ``sp`` -- tensor parallelism (Megatron column/row splits,
  parallel/tp.py) and sequence parallelism (ring or Ulysses attention,
  ops/ring_attention.py); their ranks hold the same rows of the batch.

Exactly one axis may be ``-1`` (inferred from the world size). A ``rules``
sub-dict overrides logical-axis rules, validated as in the reference.
"""

import dataclasses
from typing import Dict, Optional, Tuple

__all__ = ["MeshConfig", "CANONICAL_AXES", "resolve_extents"]

# canonical axis order: batch axes first, then tp and sp (ranks are laid
# out row-major over this order)
CANONICAL_AXES: Tuple[str, ...] = ("dp", "fsdp", "tp", "sp")

_VALID_RULE_TARGETS = frozenset(CANONICAL_AXES) | {"expert"}


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Validated ``"mesh"`` block: axis extents + logical-rule overrides."""

    dp: int = -1
    fsdp: int = 1
    tp: int = 1
    sp: int = 1
    rules: Optional[Dict[str, object]] = None
    enabled: bool = True

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "MeshConfig":
        d = dict(d or {})
        enabled = bool(d.pop("enabled", True))
        rules = d.pop("rules", None)
        if rules is not None:
            if not isinstance(rules, dict):
                raise ValueError(
                    f'"rules" must be a dict of logical-axis overrides, '
                    f"got {type(rules).__name__}")
            for k, v in rules.items():
                targets = v if isinstance(v, (tuple, list)) else (v,)
                for t in targets:
                    if t is not None and t not in _VALID_RULE_TARGETS:
                        raise ValueError(
                            f"rules[{k!r}] names unknown mesh axis {t!r} "
                            f"(valid: {sorted(_VALID_RULE_TARGETS)} or null)")
            rules = {k: (tuple(v) if isinstance(v, list) else v)
                     for k, v in rules.items()}
        unknown = set(d) - set(CANONICAL_AXES)
        if unknown:
            raise ValueError(
                f"unknown mesh keys {sorted(unknown)}; valid keys: "
                f"{list(CANONICAL_AXES)} + ['rules', 'enabled']")
        dims = {}
        for a in CANONICAL_AXES:
            v = d.get(a, -1 if a == "dp" else 1)
            if not isinstance(v, int) or isinstance(v, bool):
                raise ValueError(f'mesh axis "{a}" must be an int, got {v!r}')
            if v == 0 or v < -1:
                raise ValueError(
                    f'mesh axis "{a}" must be a positive extent or -1 '
                    f"(inferred), got {v}")
            dims[a] = v
        inferred = [a for a, v in dims.items() if v == -1]
        if len(inferred) > 1:
            raise ValueError(
                f"at most one mesh axis may be -1 (inferred); got "
                f"{inferred}")
        return cls(rules=rules, enabled=enabled, **dims)

    def axis_dims(self) -> Dict[str, int]:
        """{axis: extent} in canonical order (``-1`` still to be inferred)."""
        return {a: getattr(self, a) for a in CANONICAL_AXES}

    def as_dict(self) -> dict:
        out = {a: getattr(self, a) for a in CANONICAL_AXES}
        if self.rules:
            out["rules"] = {k: list(v) if isinstance(v, tuple) else v
                            for k, v in self.rules.items()}
        return out

    def resolve(self, world: int) -> Dict[str, int]:
        """Full extents for ``world`` ranks — the reference's single ``-1``
        inference, needing no process group."""
        dims = self.axis_dims()
        inferred = [a for a, v in dims.items() if v == -1]
        known = 1
        for v in dims.values():
            if v != -1:
                known *= v
        if inferred:
            if world % known != 0:
                raise ValueError(
                    f"cannot infer mesh axis {inferred[0]!r}: known "
                    f"extents multiply to {known}, which does not divide "
                    f"world={world}")
            dims[inferred[0]] = world // known
        elif known != world:
            raise ValueError(
                f"mesh extents {dims} multiply to {known} != "
                f"world={world}")
        return dims


def resolve_extents(block: Optional[dict], world: int) -> Dict[str, int]:
    """Validate a ``"mesh"`` block and resolve it to full canonical
    extents for ``world`` ranks (module-level convenience over
    :meth:`MeshConfig.resolve`)."""
    return MeshConfig.from_dict(block).resolve(world)
