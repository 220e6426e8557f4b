"""Shared set-up of the streamed-offload tests (tests/test_torch_streaming
*.py): the tiny GPT both packages train (the reference's own test model,
tests/test_streaming_offload.py), its seeded batches, engines of both
packages on the same params, and a single OpenMP thread for the host
library, so six test workers do not oversubscribe the cores."""

import ctypes
import ctypes.util
import os

os.environ.setdefault("OMP_NUM_THREADS", "1")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from deeperspeed_tpu.models.gpt import GPTConfig as JaxGPTConfig  # noqa: E402
from deeperspeed_tpu.models.gpt import init_params  # noqa: E402
from deeperspeed_tpu.runtime.offload import (  # noqa: E402
    streaming as jax_streaming)
from deeperspeed_tpu_torch.models.gpt import GPTConfig  # noqa: E402
from deeperspeed_tpu_torch.runtime.offload import streaming  # noqa: E402

torch.set_num_threads(1)
_gomp = ctypes.util.find_library("gomp")
if _gomp:
    ctypes.CDLL(_gomp).omp_set_num_threads(1)

V, S, B = 128, 16, 2
TORCH_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}
JAX_DTYPES = {"fp32": jnp.float32, "bf16": jnp.bfloat16}


def model_kw(**kw):
    base = dict(vocab_size=V, n_layer=4, n_head=2, d_model=32, max_seq=64,
                rotary=True, tie_embeddings=True, remat=True,
                attn_impl="xla", ce_chunk=0)
    base.update(kw)
    return base


def tiny_cfg(dtype="fp32", **kw):
    """The port's tiny GPT (4 layers, d_model 32, 2 heads, dense
    attention, kernels off)."""
    return GPTConfig(dtype=TORCH_DTYPES[dtype], **model_kw(**kw))


def jax_cfg(dtype="fp32", **kw):
    return JaxGPTConfig(dtype=JAX_DTYPES[dtype], **model_kw(**kw))


def batch(seed=0, n=1):
    """Zipf-like tokens, (n, B, S+1): the reference test's batches."""
    r = np.random.default_rng(seed)
    probs = 1.0 / np.arange(1, V + 1) ** 1.2
    probs /= probs.sum()
    return r.choice(V, size=(n, B, S + 1), p=probs).astype(np.int32)


def params_np(seed=0, dtype="fp32", **kw):
    """The reference's init_params, as numpy: both packages take it."""
    return jax.tree.map(np.asarray,
                        init_params(jax.random.PRNGKey(seed),
                                    jax_cfg(dtype, **kw)))


def scfg(**kw):
    base = dict(micro_batch=B, seq=S, group_layers=2)
    base.update(kw)
    return streaming.StreamConfig(**base)


def port_engine(cfg, sc, params=None):
    return streaming.StreamedOffloadEngine(cfg, sc, host_params=params,
                                           device="cpu")


def jax_engine(cfg, sc, params=None):
    return jax_streaming.StreamedOffloadEngine(
        cfg, jax_streaming.StreamConfig(**sc.__dict__), host_params=params)


def rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))
