"""The port's block-sparse attention against the reference's.

Inputs come from seeded numpy and go to both packages. The reference runs
its Pallas kernels in interpret mode, as tests/test_sparse_attention.py
does; on the CPU the port's kernel wrappers take their plain versions.
Tolerances are the reference's own for its kernels in fp32: outputs
within 2e-5, gradients within 5e-4. ``check_factory`` holds
make_block_sparse_attention to the reference on each of its TPU routes;
its cases sit in tests/test_torch_sparse_{stream,resident,split}.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeperspeed_tpu.ops import sparse_attention as ref
from deeperspeed_tpu.ops.sparse_attention import kernels as ref_kernels
from deeperspeed_tpu_torch.models import convert
from deeperspeed_tpu_torch.ops import sparse_attention as port
from deeperspeed_tpu_torch.ops.sparse_attention import block_sparse, kernels

torch.set_num_threads(1)

H, BLOCK, S = 2, 8, 64
OUT_TOL, GRAD_TOL = 2e-5, 5e-4
NEG_INF = kernels.NEG_INF


def _layout(name, causal, S=S, heads=H):
    attention = "unidirectional" if causal else "bidirectional"
    cfgs = {
        "fixed": lambda: ref.FixedSparsityConfig(
            num_heads=heads, block=BLOCK, num_local_blocks=2,
            attention=attention),
        "bigbird": lambda: ref.BigBirdSparsityConfig(
            num_heads=heads, block=BLOCK, different_layout_per_head=True,
            num_random_blocks=1, attention=attention),
        "bslongformer": lambda: ref.BSLongformerSparsityConfig(
            num_heads=heads, block=BLOCK, num_sliding_window_blocks=3,
            attention=attention),
        "variable": lambda: ref.VariableSparsityConfig(
            num_heads=heads, block=BLOCK, num_random_blocks=1,
            local_window_blocks=[2, 3], global_block_indices=[0],
            attention=attention),
        "local": lambda: ref.LocalSlidingWindowSparsityConfig(
            num_heads=heads, block=BLOCK, num_sliding_window_blocks=3,
            attention=attention),
        "dense": lambda: ref.DenseSparsityConfig(num_heads=heads,
                                                 block=BLOCK),
    }
    return cfgs[name]().make_layout(S)


def _arrays(seed, *shapes):
    rs = np.random.default_rng(seed)
    return [rs.standard_normal(s).astype(np.float32) for s in shapes]


def _ref_fwd_vjp(fn, q, k, v, do):
    def run(q, k, v, do):
        o, vjp = jax.vjp(fn, q, k, v)
        return o, vjp(do)

    o, grads = jax.jit(run)(*(jnp.asarray(x) for x in (q, k, v, do)))
    return np.asarray(o), [np.asarray(g) for g in grads]


def _port_fwd_vjp(fn, q, k, v, do):
    t = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    o = fn(*t)
    grads = torch.autograd.grad(o, t, torch.tensor(do))
    return o.detach().numpy(), [g.numpy() for g in grads]


def _close(got, want, tol):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


LAYOUTS = ("fixed", "bigbird", "bslongformer", "variable", "local", "dense")
FACTORY_CASES = [(name, causal) for name in LAYOUTS for causal in (False, True)]


def check_factory(name, causal, impl):
    """make_block_sparse_attention: the port (its plain versions on the
    CPU) against the reference's kernels in interpret mode on the route
    ``impl``, forward and gradients. The cases run in one file per route
    (tests/test_torch_sparse_{stream,resident,split}.py), so that no file
    outgrows its share of the tier-1 time."""
    layout = _layout(name, causal)
    q, k, v, do = _arrays(0, *[(2, S, H, 16)] * 4)
    want_o, want_g = _ref_fwd_vjp(ref.make_block_sparse_attention(
        layout, BLOCK, causal=causal, interpret=True, impl=impl), q, k, v, do)
    got_o, got_g = _port_fwd_vjp(port.make_block_sparse_attention(
        layout, BLOCK, causal=causal, impl=impl), q, k, v, do)
    _close(got_o, want_o, OUT_TOL)
    for a, b in zip(got_g, want_g):
        _close(a, b, GRAD_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_interpret_and_xla_match_the_reference(causal):
    """interpret=True (the plain versions by name) and the dense-mask
    block_sparse_attention_xla against the reference's."""
    layout = _layout("bigbird", causal)
    q, k, v, do = _arrays(1, *[(2, S, H, 16)] * 4)
    want_o, want_g = _ref_fwd_vjp(ref.make_block_sparse_attention(
        layout, BLOCK, causal=causal, interpret=True, impl="stream"),
        q, k, v, do)
    got_o, got_g = _port_fwd_vjp(port.make_block_sparse_attention(
        layout, BLOCK, causal=causal, interpret=True), q, k, v, do)
    _close(got_o, want_o, OUT_TOL)
    for a, b in zip(got_g, want_g):
        _close(a, b, GRAD_TOL)
    xla = lambda *t: ref.block_sparse_attention_xla(*t, layout, BLOCK,
                                                    causal=causal)
    want_o, want_g = _ref_fwd_vjp(xla, q, k, v, do)
    got_o, got_g = _port_fwd_vjp(
        lambda *t: port.block_sparse_attention_xla(*t, layout, BLOCK,
                                                   causal=causal), q, k, v, do)
    _close(got_o, want_o, OUT_TOL)
    for a, b in zip(got_g, want_g):
        _close(a, b, GRAD_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_pair_matches_the_reference_kernels(causal):
    """sparse_fwd_plain / sparse_bwd_plain against the reference's
    streaming kernels in interpret mode: o, the fp32 lse, and dq, dk, dv
    from the same (o, lse)."""
    layout = _layout("variable", causal)
    B = 2
    q, k, v, do = _arrays(2, *[(B, S, H, 16)] * 4)
    rows, cols = ref_kernels.build_flat_lut(layout, lane=ref_kernels.LANE)
    keys_t, qrows_t = ref_kernels.build_flat_lut(layout.transpose(0, 2, 1),
                                                 lane=ref_kernels.LANE)
    scale = 0.25
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    o, lse, (qf, kf, vf) = ref_kernels._bs_fwd(jq, jk, jv, rows, cols, scale,
                                               BLOCK, causal, True)
    gf = jnp.asarray(do).transpose(0, 2, 1, 3).reshape(B * H, S, 16)
    dq, dk, dv = ref_kernels._bs_bwd((qf, kf, vf, o, lse), gf, rows, cols,
                                     keys_t, qrows_t, scale, BLOCK, causal,
                                     True, H)
    t = lambda x: torch.tensor(x).transpose(1, 2).contiguous()
    lay = torch.from_numpy(kernels.causal_layout(layout, causal))
    po, plse = block_sparse.sparse_fwd_plain(t(q), t(k), t(v), lay, BLOCK,
                                             scale, causal)
    unflat = lambda x: np.asarray(x).reshape(B, H, S, -1)
    _close(po.numpy(), unflat(o), OUT_TOL)
    _close(plse.numpy(), np.asarray(lse).reshape(B, H, S), OUT_TOL)
    ro = torch.tensor(unflat(o))
    rlse = torch.tensor(np.asarray(lse).reshape(B, H, S))
    got = block_sparse.sparse_bwd_plain(t(q), t(k), t(v), ro, rlse, t(do),
                                        lay, BLOCK, scale, causal)
    for a, b in zip(got, (dq, dk, dv)):
        _close(a.numpy(), unflat(b), GRAD_TOL)


def test_csr_tables_follow_the_causal_filter():
    """Both tables come from the one causally filtered layout: the
    transposed table is the transpose of the row table."""
    layout = _layout("bigbird", False)
    for causal in (False, True):
        lut = kernels.SparseLut(layout, BLOCK, causal)
        ro, rc, co, cr = lut._tables
        H_, nb = layout.shape[:2]
        dense_r = np.zeros((H_, nb, nb), bool)
        dense_c = np.zeros((H_, nb, nb), bool)
        for h in range(H_):
            for i in range(nb):
                dense_r[h, i, rc[ro[h * nb + i]:ro[h * nb + i + 1]]] = True
                dense_c[h, i, cr[co[h * nb + i]:co[h * nb + i + 1]]] = True
        assert np.array_equal(dense_r, kernels.causal_layout(layout, causal))
        assert np.array_equal(dense_c, dense_r.transpose(0, 2, 1))
        if causal:
            assert not np.triu(dense_r, 1).any()
        assert lut.active_blocks == int(dense_r.sum())
    cols, counts = port.build_lut(layout)
    rcols, rcounts = ref.build_lut(layout)
    assert np.array_equal(cols, rcols) and np.array_equal(counts, rcounts)
    assert port.layout_density(layout) == ref.kernels.layout_density(layout)


@pytest.mark.parametrize("impl", ["stream", "resident"])
def test_empty_rows_give_zeros_and_zero_gradients(impl):
    """A layout row with no block writes o = 0 and lse = NEG_INF; its
    gradients are zero, not NaN, and the whole output agrees with the
    reference's kernels."""
    layout = np.zeros((1, 4, 4), np.int64)
    layout[0, 0, 0] = 1
    layout[0, 2, 1] = 1
    q, k, v, do = _arrays(3, *[(1, 32, 1, 16)] * 4)
    want_o, want_g = _ref_fwd_vjp(ref.make_block_sparse_attention(
        layout, BLOCK, interpret=True, impl=impl), q, k, v, do)
    got_o, got_g = _port_fwd_vjp(port.make_block_sparse_attention(
        layout, BLOCK, impl=impl), q, k, v, do)
    assert np.isfinite(got_o).all() and all(np.isfinite(g).all()
                                            for g in got_g)
    assert np.abs(got_o[:, 8:16]).max() == 0.0
    assert np.abs(got_o[:, 24:]).max() == 0.0
    assert np.abs(got_g[0][:, 8:16]).max() == 0.0   # dq of an empty row
    assert np.abs(got_g[1][:, 16:]).max() == 0.0    # dk of unseen keys
    _close(got_o, want_o, OUT_TOL)
    for a, b in zip(got_g, want_g):
        _close(a, b, GRAD_TOL)
    lut = kernels.SparseLut(layout, BLOCK, False).on("cpu")
    t = lambda x: torch.tensor(x).transpose(1, 2).contiguous()
    _, lse = block_sparse.sparse_fwd(t(q), t(k), t(v), lut, 0.25, False)
    assert (lse[0, 0, 8:16] == NEG_INF).all() and (lse[0, 0, :8] > -1e3).all()


@pytest.mark.parametrize("name,causal", [("fixed", False), ("local", True)])
def test_key_padding_mask_matches_the_reference_masked_path(name, causal):
    """A mask dropping the last quarter of the keys (with a row whose
    visible keys all fall there, under the causal window) and a finite
    bias on others: the port's kernel route on the CPU, interpret route and
    dense route against the reference module's masked (dense) path,
    forward and gradients."""
    layout_cfg = (ref.FixedSparsityConfig(num_heads=H, block=BLOCK,
                                          num_local_blocks=2)
                  if name == "fixed" else
                  ref.LocalSlidingWindowSparsityConfig(
                      num_heads=H, block=BLOCK, num_sliding_window_blocks=1))
    port_cfg = (port.FixedSparsityConfig(num_heads=H, block=BLOCK,
                                         num_local_blocks=2)
                if name == "fixed" else
                port.LocalSlidingWindowSparsityConfig(
                    num_heads=H, block=BLOCK, num_sliding_window_blocks=1))
    B = 2
    q, k, v, do = _arrays(4, *[(B, H, S, 16)] * 4)
    kpm = np.zeros((B, S), np.float32)
    kpm[:, 3 * S // 4:] = -1e30
    kpm[1, 5] = -2.5
    ra = ref.SparseSelfAttention(layout_cfg, max_seq_length=S, causal=causal)

    def run(q, k, v, do):
        o, vjp = jax.vjp(lambda *t: ra(*t, key_padding_mask=jnp.asarray(kpm)),
                         q, k, v)
        return o, vjp(do)

    want_o, want_g = run(*(jnp.asarray(x) for x in (q, k, v, do)))
    for impl in ("auto", "pallas_interpret", "xla"):
        pa = port.SparseSelfAttention(port_cfg, max_seq_length=S,
                                      causal=causal, impl=impl)
        got_o, got_g = _port_fwd_vjp(
            lambda *t: pa(*t, key_padding_mask=torch.tensor(kpm)),
            q, k, v, do)
        _close(got_o, np.asarray(want_o), OUT_TOL)
        for a, b in zip(got_g, want_g):
            _close(a, np.asarray(b), GRAD_TOL)
    if causal:  # the window rows past 3/4 see only dropped keys
        assert np.abs(got_o[:, :, 3 * S // 4:]).max() == 0.0


def test_module_slices_the_master_layout_and_raises_as_the_reference():
    cfg_r = ref.FixedSparsityConfig(num_heads=H, block=BLOCK,
                                    num_local_blocks=2,
                                    attention="unidirectional")
    cfg_p = port.FixedSparsityConfig(num_heads=H, block=BLOCK,
                                     num_local_blocks=2,
                                     attention="unidirectional")
    ra = ref.SparseSelfAttention(cfg_r, max_seq_length=128,
                                 impl="pallas_interpret")
    pa = port.SparseSelfAttention(cfg_p, max_seq_length=128)
    assert pa.causal and ra.causal
    assert np.array_equal(pa.master_layout, ra.master_layout)
    for L in (64, 32):
        q, k, v = _arrays(5 + L, *[(1, H, L, 16)] * 3)
        want = np.asarray(ra(*(jnp.asarray(x) for x in (q, k, v))))
        got = pa(*(torch.tensor(x) for x in (q, k, v)))
        assert np.array_equal(pa.get_layout(L), ra.get_layout(L))
        _close(got.numpy(), want, OUT_TOL)
    assert set(pa._ops) == {(64, 16, torch.device("cpu")),
                            (32, 16, torch.device("cpu"))}
    x = torch.zeros(1, H, 60, 16)
    with pytest.raises(ValueError, match="divisible by Block size"):
        pa(x, x, x)
    with pytest.raises(NotImplementedError, match="self-attention"):
        pa(torch.zeros(1, H, 64, 16), torch.zeros(1, H, 32, 16),
           torch.zeros(1, H, 32, 16))
    x = torch.zeros(1, H, 64, 16)
    with pytest.raises(ValueError, match="CUDA"):
        port.SparseSelfAttention(cfg_p, max_seq_length=128,
                                 impl="pallas")(x, x, x)


def test_factory_errors_equal_the_reference():
    layout = _layout("fixed", False)
    for impl in ("auto", "stream"):
        r = ref.make_block_sparse_attention(layout, BLOCK, interpret=True,
                                            impl=impl)
        p = port.make_block_sparse_attention(layout, BLOCK, impl=impl)
        for shape in ((1, S, H + 1, 16), (1, S - BLOCK, H, 16)):
            with pytest.raises(ValueError) as want:
                r(*[jnp.zeros(shape)] * 3)
            with pytest.raises(ValueError) as got:
                p(*[torch.zeros(shape)] * 3)
            assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        ref.make_block_sparse_attention(layout, BLOCK, impl="flash")
    with pytest.raises(ValueError) as got:
        port.make_block_sparse_attention(layout, BLOCK, impl="flash")
    assert str(got.value) == str(want.value)


def test_bert_sparse_self_attention_with_converted_weights():
    """The reference's BertSparseSelfAttention params, carried across by
    models/convert.py, give the same output and input gradient."""
    D = 32
    rcfg = ref.BigBirdSparsityConfig(num_heads=H, block=BLOCK)
    pcfg = port.BigBirdSparsityConfig(num_heads=H, block=BLOCK)
    rmod = ref.BertSparseSelfAttention(D, H, rcfg, max_seq_length=S)
    pmod = port.BertSparseSelfAttention(D, H, pcfg, max_seq_length=S)
    jparams = rmod.init(jax.random.PRNGKey(0))
    jparams = jax.tree.map(lambda a: np.asarray(a), jparams)
    jparams["key"]["b"] = _arrays(6, (D,))[0]
    params = convert.from_jax_sparse_attention_params(jparams, D, "cpu")
    back = convert.to_numpy_sparse_attention_params(params)
    assert all(np.array_equal(back[n][w], jparams[n][w])
               for n in jparams for w in ("w", "b"))
    h, g = _arrays(7, (2, S, D), (2, S, D))

    def run(h, g):
        o, vjp = jax.vjp(lambda x: rmod.apply(jparams, x), h)
        return o, vjp(g)[0]

    want_o, want_dh = run(jnp.asarray(h), jnp.asarray(g))
    th = torch.tensor(h, requires_grad=True)
    got_o = pmod.apply(params, th)
    (got_dh,) = torch.autograd.grad(got_o, th, torch.tensor(g))
    _close(got_o.detach().numpy(), np.asarray(want_o), OUT_TOL)
    _close(got_dh.numpy(), np.asarray(want_dh), GRAD_TOL)
    init = pmod.init(3, device="cpu", dtype=torch.bfloat16)
    assert init["query"]["w"].shape == (D, D)
    assert init["query"]["w"].dtype == torch.bfloat16
    assert float(init["value"]["b"].abs().sum()) == 0.0
    with pytest.raises(ValueError, match="not a multiple"):
        port.BertSparseSelfAttention(30, 4)


class _HFConfig:
    hidden_size = 32
    num_attention_heads = H
    max_position_embeddings = 64


def _stand_in(layers=2):
    """An HF-shaped BERT built from nn.Linear modules:
    .bert.encoder.layer[i].attention.self.{query,key,value}."""
    torch.manual_seed(0)

    def mod(**kw):
        m = torch.nn.Module()
        for k, v in kw.items():
            setattr(m, k, v)
        return m

    lin = lambda: torch.nn.Linear(32, 32)
    layer = lambda: mod(attention=mod(self=mod(query=lin(), key=lin(),
                                               value=lin())))
    encoder = mod(layer=torch.nn.ModuleList([layer() for _ in range(layers)]))
    model = mod(bert=mod(encoder=encoder))
    model.config = _HFConfig()
    return model


def test_sparse_attention_utils_on_a_stand_in_bert():
    """SparseAttentionUtils on an nn.Linear stand-in of an HF BERT, against
    the reference's utilities on the same modules."""
    RU, PU = ref.SparseAttentionUtils, port.SparseAttentionUtils
    model = _stand_in()
    rcfg = ref.FixedSparsityConfig(num_heads=H, block=16)
    pcfg = port.FixedSparsityConfig(num_heads=H, block=16)
    rl, rparams = RU.replace_model_self_attention_with_sparse_self_attention(
        model, 64, rcfg)
    pl, pparams = PU.replace_model_self_attention_with_sparse_self_attention(
        model, 64, pcfg)
    assert len(pparams) == len(rparams) == 2
    assert isinstance(pl, port.BertSparseSelfAttention)
    assert pl.attn.max_seq_length == 64
    for a, b in zip(pparams, rparams):
        for n in ("query", "key", "value"):
            for w in ("w", "b"):
                assert np.array_equal(a[n][w].numpy(), np.asarray(b[n][w]))
    qw = model.bert.encoder.layer[0].attention.self.query.weight
    assert torch.equal(pparams[0]["query"]["w"], qw.detach().t())
    h = _arrays(8, (2, 64, 32))[0]
    got = pl.apply(pparams[1], torch.tensor(h))
    want = rl.apply(rparams[1], jnp.asarray(h))
    _close(got.detach().numpy(), np.asarray(want), OUT_TOL)
    one_l, one = PU.replace_self_attention_layer_with_sparse_self_attention_layer(
        _HFConfig(), model.bert.encoder.layer[0], pcfg)
    assert one_l.attn.max_seq_length == 64
    assert torch.equal(one["key"]["w"], pparams[0]["key"]["w"])
    with pytest.raises(ValueError, match="BERT/RoBERTa"):
        bare = torch.nn.Module()
        bare.config = _HFConfig()
        PU.replace_model_self_attention_with_sparse_self_attention(bare, 64)

    emb = _arrays(9, (8, 4))[0]
    for n in (20, 8, 4):
        got = PU.extend_position_embedding(torch.tensor(emb), n)
        want = RU.extend_position_embedding(emb, n)
        assert np.array_equal(got.numpy(), np.asarray(want))

    ids = np.arange(2 * 13).reshape(2, 13)
    mask = np.ones((2, 13), np.int64)
    embeds = _arrays(10, (2, 13, 4))[0]
    table = _arrays(11, (40, 4))[0]
    got = PU.pad_to_block_size(16, torch.tensor(ids), torch.tensor(mask),
                               torch.tensor(mask), None, torch.tensor(embeds),
                               pad_token_id=5,
                               model_embeddings=torch.tensor(table))
    want = RU.pad_to_block_size(16, ids, mask, mask, None, embeds,
                                pad_token_id=5, model_embeddings=table)
    assert got[0] == want[0] == 3
    for a, b in zip(got[1:], want[1:]):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    out = torch.zeros(2, 16, 4)
    assert PU.unpad_sequence_output(3, out).shape == (2, 13, 4)
    assert PU.unpad_sequence_output(0, out).shape == (2, 16, 4)
    none = PU.pad_to_block_size(16, inputs_embeds=torch.tensor(embeds))
    assert none[0] == 3 and none[5].shape == (2, 16, 4)
    assert float(none[5][:, 13:].abs().sum()) == 0.0

    tok = type("T", (), {"init_kwargs": {}})()
    PU.update_tokenizer_model_max_length(tok, 4096)
    assert tok.model_max_length == 4096
    assert tok.init_kwargs["model_max_length"] == 4096
