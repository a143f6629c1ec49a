"""Operations and bytes from shapes: the model FLOPs of MIMRL's steps and
the roofline bound of each attention kernel launch, with the card's
published peaks.

Model FLOPs count two per multiply-add of every product the model's
equations need, once (no recomputation), over every row of every batch
computed (a cycle-padded row is computed too): BERT's dense products and
its two attention products over all ``time_len`` positions, ``W_t``, the
GRU's input and recurrent products, CubeMLP's axis products and residual
projections, the classifier, and the estimator bank's products. Elementwise
work, LayerNorms, softmax and lookups are left out. A backward pass counts
twice its forward's products; stage 1's forward carries no gradient and its
backward reaches the estimators alone.
"""

from __future__ import annotations

from typing import Dict, Tuple

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at 700 W
PEAK_FLOPS = {"bfloat16": 989e12, "tfloat32": 495e12, "float32": 67e12,
              "int8": 1979e12}
PEAK_BYTES_PER_S = 3.35e12
EST_HIDDEN, EST_EMBED, EST_LAYERS = 256, 128, 2


def _dims(text: str):
    return [[int(v) for v in b.split("-")] for b in text.split("=")]


def bert_dense_macs_per_token(H: int, ffn: int, layers: int) -> int:
    """Multiply-adds of BERT's dense products for one token's forward."""
    return layers * (4 * H * H + 2 * H * ffn)


def bert_attention_macs_per_token(H: int, T: int, layers: int) -> int:
    """q k^T and p v for one query position against T keys."""
    return layers * 2 * T * H


def model_macs(flags: Dict, d_audio: int, d_video: int) -> Dict[str, int]:
    """Multiply-adds of one batch's forward, by part: ``bert``, ``towers``
    (W_t, the GRUs, CubeMLP, the classifier) and, per loss evaluation,
    ``critics`` (the five InfoNCE critics) and ``classifiers`` (the six
    conditional-MI classifiers)."""
    bs, T, d = (int(flags[k]) for k in ("--batch_size", "--time_len",
                                         "--d_common"))
    H = int(flags.get("--bert_hidden", 768))
    layers = int(flags.get("--bert_layers", 12))
    ffn = int(flags.get("--bert_intermediate", 4 * H))
    tokens = bs * T
    bert = tokens * (bert_dense_macs_per_token(H, ffn, layers)
                     + bert_attention_macs_per_token(H, T, layers))
    towers = tokens * H * d  # W_t
    for d_in in (d_audio, d_video):  # two bidirectional GRU layers
        for n_in in (d_in, 2 * d):
            towers += 2 * tokens * 3 * d * (n_in + d)
    dims = [T, 3, d]
    for hid, out in zip(_dims(flags["--d_hiddens"]), _dims(flags["--d_outs"])):
        for axis in range(3):
            rest = bs
            for j in range(3):
                if j != axis:
                    rest *= dims[j]
            towers += rest * (dims[axis] * hid[axis] + hid[axis] * out[axis])
            towers += rest * dims[axis] * out[axis]  # residual projection
            dims = dims[:axis] + [out[axis]] + dims[axis + 1:]
    towers += bs * d  # classifier
    mlp = d * EST_HIDDEN + EST_LAYERS * EST_HIDDEN ** 2 + EST_HIDDEN * EST_EMBED
    critics = 5 * (2 * bs * mlp + bs * bs * EST_EMBED)
    cls = 3 * EST_EMBED * EST_HIDDEN + 2 * EST_HIDDEN ** 2 + EST_HIDDEN * 2
    classifiers = 6 * 2 * bs * cls
    return {"bert": bert, "towers": towers, "critics": critics,
            "classifiers": classifiers}


def train_epoch_flops(flags: Dict, d_audio: int, d_video: int,
                      nb_train: int, nb_eval: int, with_bank: bool = True
                      ) -> float:
    """Model FLOPs of one whole epoch: ``stage1_n`` passes of stage 1
    (a forward, the bank's forward and backward), stage 2 (forward and
    backward, the bank's terms with a bank) and the eval batches' forwards
    (with the bank's terms)."""
    m = model_macs(flags, d_audio, d_video)
    fwd = m["bert"] + m["towers"]
    bank = m["critics"] + m["classifiers"]
    n1 = int(flags["--stage1_n"]) if with_bank else 0
    stage1 = n1 * nb_train * (fwd + 3 * bank)
    stage2 = nb_train * 3 * (fwd + (bank if with_bank else 0))
    evals = nb_eval * (fwd + (bank if with_bank else 0))
    return 2.0 * (stage1 + stage2 + evals)


def serve_batch_flops(flags: Dict, d_audio: int, d_video: int) -> float:
    m = model_macs(flags, d_audio, d_video)
    return 2.0 * (m["bert"] + m["towers"])


def attention_bound_s(shape: Tuple[int, int, int, int], dtype: str,
                      backward: bool) -> float:
    """Least seconds of one attention launch on [bs, heads, T, hd]: the
    larger of its operations over the dtype's peak (float32 at the faster
    of the FP32 pipes and 3xTF32, three TF32 products each) and its bytes
    over the HBM rate. Forward: q, k, v read and out written once, the
    [bs, T] float32 mask bias read, 2 products; backward: q, k, v, dO read
    and dq, dk, dv written, 5 products (the kernels save nothing but the
    inputs and the dropout seed)."""
    bs, nh, t, hd = shape
    tensors, products = (7, 5) if backward else (4, 2)
    size = {"bfloat16": 2, "float32": 4}[dtype]
    nbytes = tensors * bs * nh * t * hd * size + bs * t * 4
    ops = 2 * products * bs * nh * t * t * hd
    if dtype == "float32":
        t_ops = min(ops / PEAK_FLOPS["float32"],
                    3 * ops / PEAK_FLOPS["tfloat32"])
    else:
        t_ops = ops / PEAK_FLOPS[dtype]
    return max(nbytes / PEAK_BYTES_PER_S, t_ops)
