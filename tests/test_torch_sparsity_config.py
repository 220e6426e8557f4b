"""The port's sparsity configs against the reference's: every class, at
several lengths and argument sets, builds layouts ``np.array_equal`` to
the reference's (per-head layouts and both random families included, on a
first and a second ``make_layout``); the constructors and
``sparsity_config_from_dict`` raise the same errors; and a
"sparse_attention" config block parses and builds through
``TrainingConfig.get_sparse_attention`` as the reference's does."""

import numpy as np
import pytest

from deeperspeed_tpu.ops import sparse_attention as ref
from deeperspeed_tpu.runtime.config import TrainingConfig as RefConfig
from deeperspeed_tpu_torch.ops import sparse_attention as port
from deeperspeed_tpu_torch.runtime.config import TrainingConfig

# (class name, kwargs, sequence lengths)
CASES = [
    ("DenseSparsityConfig", dict(num_heads=2, block=8), (64, 32)),
    ("FixedSparsityConfig", dict(num_heads=2, block=8), (64, 40, 128)),
    ("FixedSparsityConfig",
     dict(num_heads=4, block=16, num_local_blocks=4, num_global_blocks=1,
          attention="unidirectional"), (256, 80)),
    ("FixedSparsityConfig",
     dict(num_heads=4, block=16, different_layout_per_head=True,
          num_local_blocks=4, num_global_blocks=1,
          horizontal_global_attention=True,
          num_different_global_patterns=4), (256, 208)),
    ("FixedSparsityConfig",
     dict(num_heads=3, block=8, num_local_blocks=6, num_global_blocks=2,
          different_layout_per_head=True, num_different_global_patterns=3),
     (96, 104)),
    ("FixedSparsityConfig", dict(num_heads=2, block=8, num_global_blocks=0),
     (64,)),
    ("VariableSparsityConfig", dict(num_heads=2, block=8), (64, 96)),
    ("VariableSparsityConfig",
     dict(num_heads=3, block=8, different_layout_per_head=True,
          num_random_blocks=2, local_window_blocks=[2, 3, 4],
          global_block_indices=[0, 5], global_block_end_indices=[2, 7],
          horizontal_global_attention=True, seed=7), (128, 72)),
    ("VariableSparsityConfig",
     dict(num_heads=2, block=16, num_random_blocks=1,
          global_block_indices=[1, 40], attention="unidirectional"),
     (256,)),
    ("BigBirdSparsityConfig", dict(num_heads=2, block=8), (64, 128)),
    ("BigBirdSparsityConfig",
     dict(num_heads=4, block=16, different_layout_per_head=True,
          num_random_blocks=3, num_sliding_window_blocks=5,
          num_global_blocks=2, seed=3), (256, 160)),
    ("BigBirdSparsityConfig",
     dict(num_heads=2, block=8, num_random_blocks=2,
          attention="unidirectional", seed=11), (96,)),
    ("BSLongformerSparsityConfig", dict(num_heads=2, block=8), (64,)),
    ("BSLongformerSparsityConfig",
     dict(num_heads=3, block=16, different_layout_per_head=True,
          num_sliding_window_blocks=5, global_block_indices=[0, 4, 30],
          global_block_end_indices=[2, 6, 31],
          attention="unidirectional"), (256, 96)),
    ("LocalSlidingWindowSparsityConfig", dict(num_heads=2, block=8),
     (64, 48)),
    ("LocalSlidingWindowSparsityConfig",
     dict(num_heads=2, block=128, num_sliding_window_blocks=14,
          attention="bidirectional"), (4096,)),
]


@pytest.mark.parametrize("name,kwargs,lengths", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_layouts_equal_the_reference(name, kwargs, lengths):
    """Same layouts, call after call: the random families draw from one
    generator made in __init__, so the second make_layout of each length
    differs from the first exactly as the reference's does."""
    a = getattr(ref, name)(**kwargs)
    b = getattr(port, name)(**kwargs)
    for _ in range(2):
        for S in lengths:
            la, lb = a.make_layout(S), b.make_layout(S)
            assert lb.dtype == la.dtype and lb.shape == la.shape
            assert np.array_equal(la, lb)


def test_random_families_draw_anew_on_a_second_layout():
    for name in ("VariableSparsityConfig", "BigBirdSparsityConfig"):
        cfg = getattr(port, name)(num_heads=2, block=8, num_random_blocks=2)
        assert not np.array_equal(cfg.make_layout(256), cfg.make_layout(256))


def test_the_path_layout_density():
    """The Fixed block of the documented example at S 4096: 16 heads with
    4 global patterns, 274,432 active 16 x 16 blocks (density 0.262)."""
    cfg = port.FixedSparsityConfig(
        num_heads=16, block=16, different_layout_per_head=True,
        num_local_blocks=4, num_global_blocks=1,
        attention="bidirectional", horizontal_global_attention=False,
        num_different_global_patterns=4)
    lay = cfg.make_layout(4096)
    assert int(lay.sum()) == 274432
    assert abs(port.layout_density(lay) - 0.2617) < 1e-3


ERRORS = [
    ("FixedSparsityConfig", dict(num_heads=2, num_local_blocks=4,
                                 num_global_blocks=3)),
    ("FixedSparsityConfig", dict(num_heads=2, attention="sideways")),
    ("FixedSparsityConfig", dict(num_heads=2, attention="unidirectional",
                                 horizontal_global_attention=True)),
    ("FixedSparsityConfig", dict(num_heads=2,
                                 num_different_global_patterns=2)),
    ("FixedSparsityConfig", dict(num_heads=2, different_layout_per_head=True,
                                 num_local_blocks=4, num_global_blocks=2,
                                 num_different_global_patterns=3)),
    ("VariableSparsityConfig", dict(num_heads=2, global_block_indices=[0, 3],
                                    global_block_end_indices=[1])),
    ("VariableSparsityConfig", dict(num_heads=2, global_block_indices=[3],
                                    global_block_end_indices=[3])),
    ("VariableSparsityConfig", dict(num_heads=2, attention="none")),
    ("VariableSparsityConfig", dict(num_heads=2, attention="unidirectional",
                                    horizontal_global_attention=True)),
    ("BSLongformerSparsityConfig", dict(num_heads=2,
                                        global_block_indices=[0, 3],
                                        global_block_end_indices=[1])),
    ("BSLongformerSparsityConfig", dict(num_heads=2,
                                        global_block_indices=[4],
                                        global_block_end_indices=[2])),
]


def _raised(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the type is what is compared
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("name,kwargs", ERRORS,
                         ids=[f"{e[0]}-{i}" for i, e in enumerate(ERRORS)])
def test_constructor_errors_equal_the_reference(name, kwargs):
    want = _raised(lambda: getattr(ref, name)(**kwargs))
    assert want is not None
    assert _raised(lambda: getattr(port, name)(**kwargs)) == want


LAYOUT_ERRORS = [
    ("DenseSparsityConfig", dict(num_heads=2, block=8), 60),
    ("BigBirdSparsityConfig", dict(num_heads=2, block=8,
                                   num_random_blocks=9), 64),
    ("BigBirdSparsityConfig", dict(num_heads=2, block=8,
                                   num_sliding_window_blocks=9), 64),
    ("BigBirdSparsityConfig", dict(num_heads=2, block=8,
                                   num_random_blocks=0,
                                   num_global_blocks=9), 64),
    ("VariableSparsityConfig", dict(num_heads=2, block=8,
                                    num_random_blocks=9), 64),
    ("LocalSlidingWindowSparsityConfig",
     dict(num_heads=2, block=8, num_sliding_window_blocks=9), 64),
    ("SparsityConfig", dict(num_heads=2), 64),
]


@pytest.mark.parametrize("name,kwargs,S", LAYOUT_ERRORS,
                         ids=[f"{e[0]}-{i}"
                              for i, e in enumerate(LAYOUT_ERRORS)])
def test_make_layout_errors_equal_the_reference(name, kwargs, S):
    want = _raised(lambda: getattr(ref, name)(**kwargs).make_layout(S))
    assert want is not None
    assert _raised(lambda: getattr(port, name)(**kwargs).make_layout(S)) \
        == want


def test_the_base_config_raises_in_the_module_as_in_the_reference():
    """The default SparseSelfAttention() builds SparsityConfig's layout,
    which raises there as upstream's does."""
    want = _raised(lambda: ref.SparseSelfAttention())
    assert want is not None and want[0] == "NotImplementedError"
    assert _raised(lambda: port.SparseSelfAttention()) == want


DICTS = [
    {"mode": "bigbird", "block": 32, "num_sliding_window_blocks": 5},
    {"mode": "fixed", "block": 16, "different_layout_per_head": True,
     "num_local_blocks": 4, "num_global_blocks": 1,
     "attention": "bidirectional", "horizontal_global_attention": False,
     "num_different_global_patterns": 4},
    {"block": 16},
    {"mode": "dense", "block": 16},
    {"mode": "variable", "block": 16, "num_random_blocks": 2,
     "local_window_blocks": [4], "global_block_indices": [0],
     "seed": 5},
    {"mode": "bslongformer", "block": 16, "num_sliding_window_blocks": 3,
     "global_block_indices": [0]},
    {"mode": "local_sliding_window", "block": 16,
     "num_sliding_window_blocks": 3},
]


@pytest.mark.parametrize("cfg", DICTS, ids=[d.get("mode", "default")
                                            for d in DICTS])
def test_sparsity_config_from_dict_equals_the_reference(cfg):
    a = ref.sparsity_config_from_dict(8, cfg)
    b = port.sparsity_config_from_dict(8, cfg)
    assert type(b).__name__ == type(a).__name__
    assert np.array_equal(a.make_layout(512), b.make_layout(512))


@pytest.mark.parametrize("cfg", [
    {"mode": "nope"},
    {"mode": "fixed", "num_local_blocks": 4, "num_global_blocks": 3},
    {"mode": "bigbird", "not_a_key": 1},
])
def test_sparsity_config_from_dict_errors_equal_the_reference(cfg):
    want = _raised(lambda: ref.sparsity_config_from_dict(8, cfg))
    assert want is not None
    assert _raised(lambda: port.sparsity_config_from_dict(8, cfg)) == want


BASE = {"train_batch_size": 2}


def test_config_block_parses_and_builds_as_the_reference():
    """A "sparse_attention" block no longer raises in the port; the config
    keeps it, and get_sparse_attention builds the reference's layout. The
    block is the fixed-mode keys of upstream DeepSpeed's documented
    example."""
    block = DICTS[1]
    conf = dict(BASE, sparse_attention=block)
    a = RefConfig(conf).get_sparse_attention(16)
    b = TrainingConfig(conf).get_sparse_attention(16)
    assert isinstance(b, port.FixedSparsityConfig)
    assert np.array_equal(a.make_layout(4096), b.make_layout(4096))
    assert TrainingConfig(BASE).get_sparse_attention(16) is None
    assert RefConfig(BASE).get_sparse_attention(16) is None


@pytest.mark.parametrize("block", [
    {"mode": "nope"},
    {"mode": "fixed", "num_local_blocks": 4, "num_global_blocks": 3},
])
def test_invalid_block_raises_at_build_time_as_the_reference(block):
    """An unknown mode or a bad Fixed argument parses (both configs read
    the block as it is) and raises the same error when built."""
    conf = dict(BASE, sparse_attention=block)
    ra, pa = RefConfig(conf), TrainingConfig(conf)
    want = _raised(lambda: ra.get_sparse_attention(4))
    assert want is not None
    assert _raised(lambda: pa.get_sparse_attention(4)) == want
