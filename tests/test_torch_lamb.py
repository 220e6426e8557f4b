"""The PyTorch port's FusedLamb against the JAX reference's
(deeperspeed_tpu/ops/lamb.py), over several steps from the same params,
moments and gradients in fp32, with weight decay, bias correction on and
off, and the trust ratio's edge cases: a zero leaf (ratio 1) and ratios
clamped at both ends."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeperspeed_tpu.ops import lamb as jax_lamb
from deeperspeed_tpu_torch.models import convert
from deeperspeed_tpu_torch.ops import lamb

torch.set_num_threads(1)

SHAPES = {"a": (5, 7), "b": (11,), "zero": (4, 3), "tiny": (6,),
          "huge": (3, 3)}


def _trees(rs):
    p = {k: rs.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    p["zero"][:] = 0.0          # ||p|| = 0: ratio 1
    p["tiny"] *= 1e-6           # ratio clamped up to min_coeff
    p["huge"] *= 1e4            # ratio clamped down to max_coeff
    return p


@pytest.mark.parametrize("wd,bias_correction,coeffs", [
    (0.0, True, (10.0, 0.01)),
    (0.01, True, (10.0, 0.01)),
    (0.1, False, (2.0, 0.5)),
])
def test_fused_lamb_matches_reference(wd, bias_correction, coeffs):
    rs = np.random.RandomState(0)
    p0 = _trees(rs)
    grads = [{k: rs.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(4)]
    kw = dict(lr=2e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=wd,
              bias_correction=bias_correction, max_coeff=coeffs[0],
              min_coeff=coeffs[1])
    jopt, topt = jax_lamb.FusedLamb(**kw), lamb.FusedLamb(**kw)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jst = jopt.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    tst = convert.from_jax_lamb_state(jst, "cpu")
    assert tst.step == 0 and tst.exp_avg["a"].dtype == torch.float32
    for i, g in enumerate(grads):
        lr = 2e-3 * (i + 1) / 4
        jp, jst = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, jst,
                              jp, jnp.float32(lr))
        tp, tst = topt.update({k: torch.from_numpy(v) for k, v in g.items()},
                              tst, tp, lr)
    assert tst.step == int(jst.step) == 4
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   atol=1e-6, rtol=1e-6, err_msg=k)
        np.testing.assert_allclose(tst.exp_avg[k].numpy(),
                                   np.asarray(jst.exp_avg[k]), atol=1e-6,
                                   rtol=1e-6, err_msg=k)
        np.testing.assert_allclose(tst.exp_avg_sq[k].numpy(),
                                   np.asarray(jst.exp_avg_sq[k]), atol=1e-6,
                                   rtol=1e-6, err_msg=k)


def test_fused_lamb_state_and_bf16_params():
    """Moments are fp32 whatever the params' dtype; a bf16 param is
    updated in fp32 and written back in bf16, in place."""
    opt = lamb.FusedLamb(lr=1e-2, weight_decay=0.01)
    p = {"w": torch.ones(4, 4, dtype=torch.bfloat16)}
    st = opt.init(p)
    assert st.exp_avg["w"].dtype == torch.float32
    w = p["w"]
    p2, st2 = opt.update({"w": torch.full((4, 4), 0.5, dtype=torch.bfloat16)},
                         st, p)
    assert p2["w"] is w and w.dtype == torch.bfloat16
    assert st2.step == 1 and float(w[0, 0]) < 1.0
