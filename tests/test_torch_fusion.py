"""The transformer, TFN and MoE fusions of the port against the JAX
package (``mimrl_tpu/models/fusion.py``) on the CPU, one case per fusion.

Each case builds the tiny JAX ``MimrlModel`` with that fusion
(``fusion_layers=1, fusion_heads=2``, as tests/test_fusion_club.py does),
initialises it once with ``init_full`` and carries the weights across with
``state_dict_from_jax``. Then:

- the fusion module and the whole model's eval forward equal JAX's within
  1e-5 absolute in float32 (BERT on the XLA attention in JAX, the plain
  attention route in the port: no Pallas kernel is on this path), and the
  whole model within 2e-2 with BERT in bfloat16 (the fusions run in
  float32 under either compute dtype, on both sides);
- the gradient of one stage-2 objective (the MAE task loss plus the
  weighted MI losses, from kNN samples of a seeded bank drawn once by the
  port and fed to both sides) with respect to every fusion parameter
  equals JAX's within 1e-4 relative to the parameter's largest gradient
  entry (a key bias, whose gradient is 0, below 1e-6 of the largest of
  all);
- per fusion, what it alone has: the attention's dropout keeps one
  ``[S, S]`` mask for every batch row and head at the keep rate
  (transformer); the modality axis is a broadcast (TFN); on tied router
  probabilities the MoE takes JAX's experts, the lower indices
  (MoE);
- a two-epoch CPU ``cli.main`` run with the fusion trains, and
  ``Predictor`` serves its ``best_valid`` slot and repeats its valid
  score. The transformer runs with the NWJ bound and TFN with CLUB, as the
  Transformer/TFN fusion sweep of BASELINE.json pairs them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimrl_tpu.models import bert as jbert
from mimrl_tpu.models import fusion as jfusion
from mimrl_tpu.models.model import MimrlModel as JaxMimrlModel
from mimrl_tpu.models.model import init_full
from mimrl_tpu.train.losses import compute_task_loss as jax_task_loss
from mimrl_tpu_torch.cli.main import main
from mimrl_tpu_torch.data.synthetic import make_dec_fixture
from mimrl_tpu_torch.eval.predict import Predictor
from mimrl_tpu_torch.models.bert import BertConfig
from mimrl_tpu_torch.models.convert import state_dict_from_jax
from mimrl_tpu_torch.models.fusion import MultiHeadAttention
from mimrl_tpu_torch.models.model import MimrlModel
from mimrl_tpu_torch.train import steps
from mimrl_tpu_torch.train.losses import compute_task_loss
from test_torch_model import BS, D_C, T, _batch, _model_kw, _t
from test_torch_solver import N_TEST, N_TRAIN, N_VALID, _argv

torch.set_num_threads(1)

FUSIONS = ("transformer", "tfn", "moe")
F32_TOL, BF16_TOL, GRAD_TOL = 1e-5, 2e-2, 1e-4
KW = dict(fusion_layers=1, fusion_heads=2, moe_experts=4, moe_topk=2)
N_BANK, N_VALID_ROWS, K = 18, 15, 2
BOUND = {"transformer": "nwj", "tfn": "club", "moe": "infonce"}


def _jax_model(fusion, dtype=jnp.float32):
    return JaxMimrlModel(
        d_t=32, fusion=fusion, **KW, **_model_kw((4, 2, D_C)),
        bert_config=dataclasses.replace(jbert.BertConfig.tiny(),
                                        flash_attn="off", dtype=dtype))


def _port_model(fusion, params, dtype=torch.float32):
    m = MimrlModel(fusion=fusion, **KW, **_model_kw((4, 2, D_C)),
                   bert_config=dataclasses.replace(
                       BertConfig.tiny(), flash_attn="off", dtype=dtype))
    m.load_state_dict(state_dict_from_jax(params, m), strict=True)
    return m.eval()


def _jax_fusion(fusion):
    """The flax fusion module as ``MimrlModel`` builds it (model.py:163-183)."""
    if fusion == "tfn":
        return jfusion.TFNFusion(D_C, dropout=0.0)
    cls = (jfusion.TransformerFusion if fusion == "transformer"
           else jfusion.MoEFusion)
    extra = {} if fusion == "transformer" else dict(num_experts=4, top_k=2)
    return cls(D_C, T, num_layers=1, num_heads=2, dropout=0.0, **extra)


def _knn(seed=3):
    """Conditional-product samples of a seeded bank, by the port's
    sampler at fixed anchors."""
    rng = np.random.default_rng(seed)
    bank = steps.FeatureBank(N_BANK, N_VALID_ROWS, D_C)
    for f in bank.FIELDS:
        getattr(bank, f).copy_(torch.from_numpy(rng.normal(
            size=tuple(getattr(bank, f).shape)).astype(np.float32)))
    anchors = {k: torch.from_numpy(rng.choice(N_VALID_ROWS, BS // K,
                                              replace=False))
               for k in ("ac_t", "ta_c", "vc_t", "tv_c", "tc_a", "tc_v")}
    return steps.sample_all_knn(None, bank, BS, K, 1.0, anchors)


def _stage2_grads(fusion, params, pm, batch, labels):
    """d(task loss + 0.01 * sum(stage-2 MI losses)) / d(fusion params), in
    JAX (converted to the port's names) and in the port."""
    knn = _knn()
    jknn = {k: tuple(jnp.asarray(x.numpy()) for x in v) for k, v in knn.items()}
    jm = _jax_model(fusion)
    jbatch = [jnp.asarray(x) for x in batch]

    def jloss(fusion_params):
        p = dict(params, mlp_encoder=fusion_params)
        out, *feats = jm.apply({"params": p}, *jbatch, deterministic=True)
        _, mi_losses = jm.apply({"params": p}, jnp.asarray(labels), *feats,
                                jknn, method=JaxMimrlModel.compute_vmi_loss_stage2)
        return (jax_task_loss("MAE", 1, out, jnp.asarray(labels))
                + sum(0.01 * l for l in mi_losses))

    jgrads = jax.jit(jax.grad(jloss))(params["mlp_encoder"])
    want = state_dict_from_jax(
        {"mlp_encoder": jax.tree_util.tree_map(np.asarray, jgrads)},
        torch.nn.ModuleDict({"mlp_encoder": pm.mlp_encoder}))
    out, *feats = pm(*map(_t, batch))
    _, mi_losses = pm.compute_vmi_loss_stage2(_t(labels), *feats, knn)
    loss = (compute_task_loss("MAE", 1, out, _t(labels))
            + sum(0.01 * l for l in mi_losses))
    names = [n for n, _ in pm.named_parameters() if n.startswith("mlp_encoder.")]
    grads = torch.autograd.grad(loss, [pm.get_parameter(n) for n in names])
    return want, dict(zip(names, grads))


_PAIRS = {}


def _pair(fusion):
    """(JAX params as numpy, port model, batch), built once per fusion."""
    if fusion not in _PAIRS:
        batch = _batch()
        params = init_full(_jax_model(fusion), {"params": jax.random.PRNGKey(0)},
                           *map(jnp.asarray, batch))["params"]
        params = jax.tree_util.tree_map(np.asarray, params)
        _PAIRS[fusion] = params, _port_model(fusion, params), batch
    return _PAIRS[fusion]


@pytest.mark.parametrize("fusion", FUSIONS)
def test_fusion_matches_jax(fusion, tmp_path):
    params, pm, batch = _pair(fusion)

    # the fusion module alone, on seeded inputs
    x = np.random.default_rng(1).normal(size=(BS, T, 3, D_C)).astype(np.float32)
    want = _jax_fusion(fusion).apply({"params": params["mlp_encoder"]},
                                     jnp.asarray(x))
    with torch.no_grad():
        fused = pm.mlp_encoder(_t(x))
    assert fused.shape == x.shape
    np.testing.assert_allclose(fused.numpy(), np.asarray(want), rtol=0,
                               atol=F32_TOL)

    # the whole model's eval forward, float32 and BERT in bfloat16
    for jdt, tdt, tol in ((jnp.float32, torch.float32, F32_TOL),
                          (jnp.bfloat16, torch.bfloat16, BF16_TOL)):
        jm = _jax_model(fusion, jdt)
        want = jax.jit(lambda p, *a: jm.apply({"params": p}, *a,
                                              deterministic=True))(
            params, *map(jnp.asarray, batch))
        model = pm if tdt == torch.float32 else _port_model(fusion, params, tdt)
        with torch.no_grad():
            got = model(*map(_t, batch))
        for g, w in zip(got, want):
            assert g.dtype == torch.float32 and w.dtype == jnp.float32
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=tol)

    # one stage-2 gradient of the fusion's parameters
    labels = np.random.default_rng(2).normal(size=BS).astype(np.float32)
    want, got = _stage2_grads(fusion, params, pm, batch, labels)
    assert set(want) == set(got) and len(got) >= 4
    top = max(w.abs().max().item() for w in want.values())
    for name, g in got.items():
        w = want[name]
        if name.endswith("key.bias"):
            # softmax ignores a shift shared by every key: its gradient is
            # 0, and both sides hold only rounding noise
            assert max(g.abs().max(), w.abs().max()) <= 1e-6 * top, name
            continue
        scale = w.abs().max().item()
        assert scale > 0, name
        assert (g - w).abs().max().item() <= GRAD_TOL * scale, name

    if fusion == "transformer":
        _check_shared_dropout_mask()
    elif fusion == "tfn":  # one fused vector, broadcast over K
        assert all(torch.equal(fused[:, :, k], fused[:, :, 0]) for k in (1, 2))
    else:
        _check_tied_router(params, pm)

    _train_and_serve(fusion, str(tmp_path))


def _check_shared_dropout_mask():
    """Flax's ``broadcast_dropout``: one [S, S] keep mask for every batch
    row and head, scaled by 1/keep. With the query and key projections at
    0 the weights are uniform, and with the value and output projections
    the identity each output row is its mask row's kept share / keep."""
    S, d, p = 200, 4, 0.3
    attn = MultiHeadAttention(d, 2, p).train()
    with torch.no_grad():
        for n in ("query", "key", "value", "out"):
            lin = getattr(attn, n)
            lin.bias.zero_()
            lin.weight.copy_(torch.zeros(d, d) if n in ("query", "key")
                             else torch.eye(d))
        torch.manual_seed(0)
        out = attn(torch.ones(3, S, d))
    kept = out * (1 - p)  # [bs, S, d]: kept share of each row of the mask
    assert torch.allclose(kept, kept[:1, :, :1].expand_as(kept), atol=1e-6)
    rate = kept[0, :, 0].mean().item()
    # S * S = 40,000 draws: the rate's standard deviation is 0.0023
    assert abs(rate - (1 - p)) < 0.01, rate
    attn.eval()
    with torch.no_grad():
        assert torch.allclose(attn(torch.ones(3, S, d)), torch.ones(3, S, d))


def _check_tied_router(params, pm):
    """With the router at 0 every expert has probability 1/E: JAX's
    ``top_k`` takes experts 0 and 1, and so must the port."""
    tied = jax.tree_util.tree_map(lambda a: a, params["mlp_encoder"])
    tied["moe_0"] = dict(tied["moe_0"], router={
        "kernel": np.zeros_like(tied["moe_0"]["router"]["kernel"])})
    x = np.random.default_rng(4).normal(size=(BS, T, 3, D_C)).astype(np.float32)
    want = _jax_fusion("moe").apply({"params": tied}, jnp.asarray(x))
    block = pm.mlp_encoder.moe_0
    saved = block.router.weight.detach().clone()
    try:
        with torch.no_grad():
            block.router.weight.zero_()
            gates = block.gates(torch.randn(2, 5, D_C))
            got = pm.mlp_encoder(_t(x))
    finally:
        with torch.no_grad():
            block.router.weight.copy_(saved)
    assert torch.equal(gates[..., :2] > 0, torch.ones(2, 5, 2, dtype=torch.bool))
    assert torch.equal(gates[..., 2:], torch.zeros(2, 5, 2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=F32_TOL)


def _train_and_serve(fusion, root):
    make_dec_fixture(f"{root}/data", "mosi",
                     n_per_split=(N_TRAIN, N_VALID, N_TEST), d_audio=5,
                     d_video=20, max_len=15, seed=2)
    scores = main(_argv(root, "--fusion", fusion, "--fusion_layers", "1",
                        "--fusion_heads", "2", "--bound_type", BOUND[fusion],
                        "--dropout_mlp", "0.1-0.1-0.1"))
    assert all(np.isfinite(v) for s in scores for v in s.values())
    log = open(f"{root}/runs/run/Running.log").read()
    assert "Epoch:[  2]" in log
    assert ("experts run unsharded" in log) == (fusion == "moe")
    predictor = Predictor(f"{root}/runs/run", device="cpu")
    assert type(predictor.model.mlp_encoder).__name__.lower().startswith(
        fusion)
    assert predictor.evaluate_split("valid")["mae"] == pytest.approx(
        scores[0]["mae"], rel=1e-5)
