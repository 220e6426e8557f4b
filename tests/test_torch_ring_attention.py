"""The port's sequence parallelism (ops/ring_attention.py) over 4 gloo
ranks (tests/torch_gloo_worker.py) against the JAX reference's
``make_context_parallel_attention`` on a CPU device mesh of the same
shape, from the same fp32 q, k, v:

* ring and Ulysses attention, causal and not: each rank's output chunk
  and the grads of its q, k and v chunks (for ``sum(out * w)``) within
  RTOL of the reference's global arrays' chunks (the ring's backward
  rotates the other way, as ``ppermute``'s transpose does);
* the refusals: a mesh without a live sequence axis, heads that do not
  split over the axis (Ulysses), and a context-parallel ``attn_impl``
  without a mesh.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeperspeed_tpu.ops.ring_attention import \
    make_context_parallel_attention as jax_cp
from deeperspeed_tpu.parallel import build_mesh as jax_build_mesh
from deeperspeed_tpu_torch.models import gpt
from deeperspeed_tpu_torch.ops.ring_attention import (
    make_context_parallel_attention, ulysses_attention)
from deeperspeed_tpu_torch.parallel import build_mesh
from tests import torch_gloo_worker as worker

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 2e-6
DIMS = {"seq": 4}
B, S, H, DH = 2, 32, 4, 8

_RUN = {}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    if not _RUN:
        d = tmp_path_factory.mktemp("ring")
        rs = np.random.RandomState(3)
        data = {k: rs.normal(size=(B, S, H, DH)).astype(np.float32)
                for k in ("q", "k", "v", "w")}
        np.savez(d / "ring.npz", **data)
        worker.spawn("ring_run", 4, d, DIMS)
        ranks = []
        for r in range(4):
            with open(os.path.join(d, f"ring_rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
        _RUN.update(data=data, ranks=ranks)
    return _RUN


def _reference(data, strategy, causal):
    mesh = jax_build_mesh(DIMS, devices=jax.devices()[:4])
    fn = jax_cp(mesh, strategy=strategy, causal=causal)
    q, k, v, w = (jnp.asarray(data[n]) for n in ("q", "k", "v", "w"))
    out = jax.jit(fn)(q, k, v)
    grads = jax.jit(jax.grad(lambda q, k, v: jnp.sum(fn(q, k, v) * w),
                             argnums=(0, 1, 2)))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
@pytest.mark.parametrize("causal", [True, False])
def test_chunks_and_grads_match_reference(run, strategy, causal):
    out, grads = _reference(run["data"], strategy, causal)
    n = S // 4
    for i, rank in enumerate(run["ranks"]):
        got = rank[(strategy, causal)]
        sl = slice(i * n, (i + 1) * n)
        np.testing.assert_allclose(got["y"], out[:, sl], rtol=RTOL,
                                   atol=ATOL)
        for name, g, want in zip("qkv", got["grads"], grads):
            np.testing.assert_allclose(g, want[:, sl], rtol=RTOL, atol=ATOL,
                                       err_msg=f"d{name} rank {i}")


def test_refusals():
    with pytest.raises(ValueError, match="'seq'"):
        make_context_parallel_attention(build_mesh({"data": 2}, world=2),
                                        "ring")
    with pytest.raises(ValueError, match="needs a mesh"):
        gpt.make_gpt(gpt.GPTConfig(attn_impl="ulysses"))
    with pytest.raises(ValueError, match="needs a mesh"):
        gpt.causal_attention(*(torch.zeros(1, 4, 2, 8),) * 3, impl="ring")

    class _Three:
        size, rank = 3, 0

    with pytest.raises(ValueError, match="not divisible"):
        ulysses_attention(*(torch.zeros(1, 4, 4, 8),) * 3, _Three())
