"""The port's int8 path against the JAX package on the CPU: the
quantiser, the int8 GEMM's plain version, ``int8_dot`` with its three
backward modes, a tiny BERT with ``quant='int8'`` and one ``train_step``
with ``use_pallas`` and ``quant`` both set.

The same numpy arrays go through both packages. On the JAX side the int8
product runs as the JAX package's tests run it on the CPU: the Pallas kernel
in interpret mode and the ``dot_general`` route it is held to
(``tests/test_pallas.py``). On the port's side a CPU tensor takes
``int8_matmul_plain``, which is what the CUDA kernel is held to bit for bit
on the card.

Tolerances. The quantiser and the int8 product are exact functions of
their inputs (integer sums, then ``(float(acc) * sa) * sb`` in float32):
bit-equal, also with bf16 output (one round-to-nearest-even on both
sides). Full-precision products of the backward modes differ by summation
order: 1e-5 of the result's largest magnitude. A whole model is not
bit-comparable: upstream float32 noise of 1e-7 moves a value across a
rounding boundary of the quantiser now and then, which changes that int8
value by one step (1/127 of its row's largest), so the tiny BERT and the
train step carry tolerances stated at their tests.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_steps import (BS, D_C, MAIN_GROUPS, N_BANK, N_VALID, TOL,
                              Pair, _jax_anchors)

from mimrl_tpu.models import bert as jbert
from mimrl_tpu.ops import quant as jquant
from mimrl_tpu.ops.pallas.int8_matmul import int8_matmul as j_int8_matmul
from mimrl_tpu.train import optim as joptim
from mimrl_tpu.train import steps as jsteps
from mimrl_tpu_torch.models.bert import BertConfig, BertModel
from mimrl_tpu_torch.models.convert import state_dict_from_jax
from mimrl_tpu_torch.ops import quant
from mimrl_tpu_torch.ops.int8_matmul import int8_matmul, int8_matmul_plain
from mimrl_tpu_torch.train import steps

torch.set_num_threads(1)

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _quantize_case(case):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(6, 40)).astype(np.float32)
    if case == "ties":
        # amax 127 makes the scale exactly 1: halves round to even
        x = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5,
                       3.4999998, 63.5]], np.float32)
    elif case == "zero_row":
        x[2] = 0.0
    elif case == "large_row":
        x[4] *= 1000.0
    elif case == "tiny":
        x *= 1e-9  # below the 1e-8 floor of the scale
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("axis", [-1, 0])
@pytest.mark.parametrize("case", ["random", "ties", "zero_row", "large_row",
                                  "tiny"])
def test_quantize_is_bit_equal_to_jax(case, axis, dtype):
    x = _quantize_case(case)
    want_q, want_s = jquant._quantize(jnp.asarray(x).astype(dtype), axis)
    got_q, got_s = quant._quantize(_t(x).to(_TORCH_DTYPES[dtype]), axis)
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    if case == "ties" and axis == -1 and dtype == "float32":
        assert got_q[0].tolist() == [127, 0, 2, 2, 0, -2, -2, 126, -126, 3, 64]
    if case == "zero_row" and axis == -1:
        assert not got_q[2].any() and got_s[2].item() == pytest.approx(1e-8 / 127)


def _int8_case(m, k, n, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(-127, 128, size=(m, k)).astype(np.int8)
    b = rng.integers(-127, 128, size=(k, n)).astype(np.int8)
    sa = rng.uniform(0.001, 0.02, size=(m, 1)).astype(np.float32)
    sb = rng.uniform(0.001, 0.02, size=(1, n)).astype(np.float32)
    return a, b, sa, sb


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(64, 48, 96), (32, 200, 64)])
def test_int8_matmul_plain_is_bit_equal_to_jax(m, k, n, dtype):
    """Against the Pallas kernel in interpret mode and against the
    ``dot_general`` route of ``quant._int8_matmul``'s epilogue."""
    a, b, sa, sb = _int8_case(m, k, n, seed=m)
    jd = jnp.dtype(dtype)
    pallas = j_int8_matmul(*map(jnp.asarray, (a, b, sa, sb)), block_m=32,
                           block_n=32, out_dtype=jd, interpret=True)
    acc = jax.lax.dot_general(jnp.asarray(a), jnp.asarray(b),
                              (((1,), (0,)), ((), ())),
                              preferred_element_type=jnp.int32)
    xla = (acc.astype(jnp.float32) * sa * sb).astype(jd)
    got = int8_matmul(*map(_t, (a, b, sa, sb)), _TORCH_DTYPES[dtype])
    again = int8_matmul_plain(_t(a), _t(b), _t(sa), _t(sb), _TORCH_DTYPES[dtype])
    assert got.dtype == _TORCH_DTYPES[dtype] and torch.equal(got, again)
    for want in (pallas, xla):
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))


def _dot_case(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(3, 10, 24)).astype(np.float32)
    w = (rng.normal(size=(24, 16)) * 0.2).astype(np.float32)
    g = rng.normal(size=(3, 10, 16)).astype(np.float32)
    return x, w, g


def _close(got, want, tol=1e-5):
    """Within ``tol`` of the result's largest magnitude."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("mode", ["int8_fwd", "int8", "int8_all"])
def test_int8_dot_matches_jax_vjp(mode):
    """Forward bit-equal. Backward through ``jax.vjp``: the products that
    the mode sends through int8 are bit-equal (dw in 'int8' and 'int8_all',
    dx in 'int8_all'); the full-precision ones within 1e-5 of their largest
    magnitude."""
    x, w, g = _dot_case()
    want_y, vjp = jax.vjp(
        lambda x, w: jquant.int8_dot(x, w, mode, jnp.float32),
        jnp.asarray(x), jnp.asarray(w))
    want_dx, want_dw = vjp(jnp.asarray(g))

    xt, wt = _t(x).requires_grad_(), _t(w).requires_grad_()
    y = quant.int8_dot(xt, wt, mode, torch.float32)
    dx, dw = torch.autograd.grad(y, (xt, wt), _t(g))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(want_y))
    for got, want, exact in ((dx, want_dx, mode == "int8_all"),
                             (dw, want_dw, mode != "int8_fwd")):
        assert got.shape == want.shape
        if exact:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        else:
            _close(got.numpy(), want)


def test_int8_dot_bf16_and_the_linear_helper():
    """bf16 activations against a float32 weight, as BERT's layers call it:
    the output is bf16 and bit-equal to JAX's; ``quant_linear`` on torch's
    ``[out, in]`` weight equals ``QuantDense`` on the transposed kernel,
    bias added after in the compute type; the weight's gradient arrives in
    the weight's layout and type."""
    x, w, g = _dot_case(seed=1)
    bias = np.random.default_rng(2).normal(size=16).astype(np.float32)
    dense = jquant.QuantDense(16, mode="int8", dtype=jnp.bfloat16)
    params = {"params": {"kernel": jnp.asarray(w), "bias": jnp.asarray(bias)}}
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    want = dense.apply(params, xj)
    want_dw = jax.grad(lambda p: jnp.sum(
        dense.apply(p, xj).astype(jnp.float32) * g))(params)["params"]["kernel"]

    weight = _t(np.ascontiguousarray(w.T)).requires_grad_()  # [out, in]
    got = quant.quant_linear(_t(x).to(torch.bfloat16), weight, _t(bias),
                             "int8", torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.detach().float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    (dw,) = torch.autograd.grad(got, weight, _t(g).to(torch.bfloat16))
    assert dw.shape == weight.shape and dw.dtype == torch.float32
    np.testing.assert_array_equal(dw.t().numpy(), np.asarray(want_dw))
    with pytest.raises(ValueError, match="mode"):
        quant.int8_dot(_t(x), _t(w), "none")


# --------------------------------------------------------------------- #
# tiny BERT and one train step
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("mode", ["int8", "int8_fwd"])
def test_tiny_bert_with_quant_matches_jax(mode):
    """Tiny BERT, deterministic mode, converted weights, attention through
    the kernels' CPU routes on both sides. Tolerance 2e-2 absolute on
    hidden states of order 1 (LayerNorm outputs): where the two sides'
    float32 noise puts a value on either side of a rounding boundary, one
    int8 step (1/127 of the row's largest value) enters a product; without
    such a flip the sides agree to 1e-4, which the median must meet."""
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 100, (6, 10)).astype(np.int32)
    types = np.zeros((6, 10), np.int32)
    mask = (rng.uniform(size=(6, 10)) > 0.3).astype(np.int32)
    mask[:, 0] = 1
    jc = dataclasses.replace(jbert.BertConfig.tiny(), flash_attn="on",
                             quant=mode)
    jb = jbert.BertModel(jc)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jb.init)(
        jax.random.PRNGKey(0), ids, types, mask)["params"])
    want = np.asarray(jax.jit(lambda p, *a: jb.apply({"params": p}, *a))(
        params, ids, types, mask))

    holder = torch.nn.Module()
    holder.bertmodel = BertModel(dataclasses.replace(
        BertConfig.tiny(), flash_attn="on", quant=mode))
    holder.load_state_dict(state_dict_from_jax({"bertmodel": params}, holder),
                           strict=True)
    with torch.no_grad():
        got = holder.bertmodel.eval()(_t(ids), _t(types), _t(mask)).numpy()
    diff = np.abs(got - want)
    assert diff.max() <= 2e-2, diff.max()
    assert np.median(diff) <= 1e-4, np.median(diff)
    # and quantisation is on: the float32 tower differs by more than that
    plain = BertModel(dataclasses.replace(BertConfig.tiny(), flash_attn="on"))
    plain.load_state_dict(holder.bertmodel.state_dict())
    with torch.no_grad():
        ref = plain.eval()(_t(ids), _t(types), _t(mask)).numpy()
    assert 1e-3 < np.abs(got - ref).max() < 0.5


@pytest.fixture(scope="module")
def flagged_pair():
    """Both packages' training state with ``use_pallas`` and
    ``quant='int8'``; relu, so that the Pallas CubeMLP kernel in interpret
    mode computes the registry's function (its gelu is the tanh form)."""
    return Pair(optm="SGD", use_pallas=True, quant="int8", activate="relu")


def test_train_step_with_both_flags_matches_jax(flagged_pair):
    """One ``train_step`` with MI against ``StepFactory``'s, as
    test_torch_steps.py does without the flags: loss, MI vector and outputs
    to that file's 1e-4. Updated parameters (SGD, so linear in the
    gradient): the main model outside BERT to 2e-6 as there; BERT's to
    1e-4 absolute, because its weight gradients are int8 products of a
    quantised activation and a quantised output gradient, where float32
    noise flips single roundings (see the module's note)."""
    p = flagged_pair
    rng = jax.random.PRNGKey(6)
    main, bert_p, vmi, bank = p.jax_state()
    batch, labels = p.jax_batch()
    state = p.jopt_main.init(joptim.merge_params(main, bert_p))
    new_bank = jsteps.FeatureBank.create(N_BANK, N_VALID, D_C)
    (new_main, new_bert, _, want_loss, want_mis, want_out,
     _) = p.factory.train_step(
        main, bert_p, vmi, state, batch, labels, bank, new_bank, BS, rng,
        use_mi=True)
    anchors = _jax_anchors(jax.random.split(rng)[1])

    model, opt_main, _, pbank, pnew, mb, plabels = p.port_state()
    assert model.mlp_encoder.layers_stack[0].mlp_d.use_pallas
    assert model.bertmodel.config.quant == "int8"
    before = {k: v.clone() for k, v in model.state_dict().items()}
    loss, mis, out = steps.train_step(
        model, opt_main, p.cfg, mb, plabels, pbank, pnew, BS, None, True,
        anchors={k: torch.from_numpy(v) for k, v in anchors.items()})
    np.testing.assert_allclose(loss.numpy(), np.asarray(want_loss), **TOL)
    np.testing.assert_allclose(mis.numpy(), np.asarray(want_mis), **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **TOL)

    tree = dict(p.params_np)
    tree.update(jax.tree_util.tree_map(
        np.asarray, joptim.merge_params(new_main, new_bert)))
    want = state_dict_from_jax(tree, model)
    got = model.state_dict()
    moved = 0
    for name in want:
        group = name.split(".")[0]
        if group not in MAIN_GROUPS:
            continue
        atol = 1e-4 if group == "bertmodel" else 2e-6
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   rtol=0, atol=atol, err_msg=name)
        moved += int(not torch.equal(got[name], before[name]))
    assert moved >= 100  # the step did move the main model and BERT
