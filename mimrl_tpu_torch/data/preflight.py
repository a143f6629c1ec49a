"""Real-data preflight checks (the port's copy of
``mimrl_tpu.data.preflight``).

Checks a data directory, a BERT vocab and BERT weights before a run and
reports what is wrong in words a user can act on; the loaders would fail
deep inside with shape or key errors on a wrong pickle
(ref: DataLoaderCMUSDK.py:86-119, DataLoaderCMUDeclareLab.py:143-147,
DataLoaderAVEC2019.py:32-63).

    python -m mimrl_tpu_torch.data.preflight --dataset mosi_Dec \
        --data_dir /path --bert_vocab vocab.txt --bert_weights model.bin

or ``run_preflight(...)``, which returns a list of ``Finding``s (level
"error" or "warn"); ``tools/parity.py`` runs it before a real-data run and
refuses to start on an error. The codes, levels and messages are the JAX
package's. Everything runs on the host: the one torch call, ``torch.load``
of the weights, maps them to the CPU (named through ``resolve_device``).

Every check stands for a schema fact of the reference:

- Dec pickles: a list of ((words, visual, acoustic, actual_words, vlen,
  alen), label, id); MOSEI labels have 7 columns, MOSI 1
  (ref: DataLoaderCMUDeclareLab.py:143-147, :388-389).
- SDK pickles: a list of [[l_feats, a_feats, v_feats], label, label_2,
  label_7, id] (pom: an 18-column label, no label_2); the feature slots'
  widths must match the registry's tables for --text/--audio/--video
  (ref: DataLoaderCMUSDK.py:12-28, Config.py:57-71).
- AVEC pickles: avec2019/{train,dev,test}.pkl
  (ref: DataLoaderAVEC2019.py:32-63).
- vocab.txt: one token per line, the BERT special tokens among them.
- BERT weights: a torch state dict whose embedding width is --bert_hidden.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from typing import List, Optional

import numpy as np

from mimrl_tpu_torch.data import registry
from mimrl_tpu_torch.device import resolve_device


@dataclasses.dataclass
class Finding:
    level: str  # "error" | "warn"
    code: str
    message: str

    def __str__(self):
        return f"[{self.level.upper()}] {self.code}: {self.message}"


def _err(code, msg):
    return Finding("error", code, msg)


def _warn(code, msg):
    return Finding("warn", code, msg)


# ---------------------------------------------------------------- files


def expected_files(dataset: str, data_dir: str) -> List[str]:
    if "Dec" in dataset:
        name = "mosi" if "mosi" in dataset else "mosei"
        return [os.path.join(data_dir, f"{name}_{m}.pkl")
                for m in ("train", "valid", "test")]
    if "SDK" in dataset:
        name = dataset.split("_")[0]
        return [os.path.join(data_dir, f"{name}_{m}.pkl")
                for m in ("train", "valid", "test")]
    if dataset == "avec2019":
        return [os.path.join(data_dir, "avec2019", f"{m}.pkl")
                for m in ("train", "dev", "test")]
    # the local family (data/local.py's schema)
    return [os.path.join(data_dir, dataset, f"{m}.pkl")
            for m in ("train", "valid", "test")]


def check_files(dataset: str, data_dir: str) -> List[Finding]:
    out = []
    if not data_dir:
        return [_err("data_dir_missing",
                     "--data_dir is required for real-data runs")]
    if not os.path.isdir(data_dir):
        return [_err("data_dir_not_found",
                     f"--data_dir {data_dir!r} does not exist")]
    for path in expected_files(dataset, data_dir):
        if not os.path.exists(path):
            out.append(_err(
                "pickle_missing",
                f"expected {path} for dataset {dataset!r} "
                f"(file layout: docs/RUNBOOK.md)"))
    return out


# ---------------------------------------------------------------- pickles


def _load(path) -> tuple:
    try:
        with open(path, "rb") as f:
            return pickle.load(f), None
    except Exception as e:  # truncated, corrupt or not a pickle
        return None, _err("pickle_unreadable", f"{path}: {e!r}")


def check_dec_pickle(dataset: str, path: str) -> List[Finding]:
    data, err = _load(path)
    if err:
        return [err]
    out = []
    if not isinstance(data, list) or not data:
        return [_err("dec_schema", f"{path}: expected a non-empty list of "
                     "((words, visual, acoustic, actual_words, vlen, alen),"
                     " label, id) entries")]
    entry = data[0]
    if len(entry) != 3 or len(entry[0]) != 6:
        return [_err("dec_schema", f"{path}: entry 0 is not "
                     "((6 fields), label, id) — got lengths "
                     f"{len(entry)} / {len(entry[0]) if entry else '?'}")]
    (_, visual, acoustic, words, _vlen, _alen), label, _ = entry
    d_t, d_a, d_v = registry.dataset_dimensions[
        "mosi_dec" if "mosi" in dataset else "mosei_dec"]
    if np.asarray(acoustic).ndim != 2 or np.asarray(acoustic).shape[1] != d_a:
        out.append(_err("dec_audio_dim",
                        f"{path}: acoustic dim "
                        f"{np.asarray(acoustic).shape} != [T, {d_a}]"))
    if np.asarray(visual).ndim != 2 or np.asarray(visual).shape[1] != d_v:
        out.append(_err("dec_video_dim",
                        f"{path}: visual dim "
                        f"{np.asarray(visual).shape} != [T, {d_v}]"))
    if not isinstance(words, (list, np.ndarray)) or not len(words):
        out.append(_err("dec_words",
                        f"{path}: actual_words (entry[0][3]) empty — the "
                        "BERT text path needs the token list"))
    want_cols = 7 if "mosei" in dataset else 1
    lab = np.asarray(label)
    if lab.reshape(-1).shape[0] not in (want_cols,):
        out.append(_err(
            "dec_label_cols",
            f"{path}: label has {lab.reshape(-1).shape[0]} values, "
            f"expected {want_cols} "
            f"({'MOSEI 7-col sentiment' if want_cols == 7 else 'MOSI'}; "
            "ref: DataLoaderCMUDeclareLab.py:388-389)"))
    nan_frac = float(np.mean(~np.isfinite(
        np.asarray(acoustic, np.float64))))
    if nan_frac > 0.5:
        out.append(_warn("dec_nan_heavy",
                         f"{path}: {nan_frac:.0%} non-finite acoustic "
                         "values (will be NaN-scrubbed to 0)"))
    return out


def check_sdk_pickle(dataset: str, path: str, text: str, audio: str,
                     video: str) -> List[Finding]:
    data, err = _load(path)
    if err:
        return [err]
    name = dataset.split("_")[0]
    dims = registry.dataset_dimensions[dataset]
    from mimrl_tpu_torch.data.sdk import _FEATURE_LISTS

    l_names, a_names, v_names = _FEATURE_LISTS[name]
    out = []
    for flag, val, names in (("--text", text, l_names),
                             ("--audio", audio, a_names),
                             ("--video", video, v_names)):
        if val not in names:
            out.append(_err("sdk_feature_name",
                            f"{flag} {val!r} not in {names} for {dataset}"))
    if out:
        return out
    if not isinstance(data, list) or not data:
        return [_err("sdk_schema", f"{path}: expected a non-empty list")]
    entry = data[0]
    feats = entry[0]
    if len(feats) != 3:
        return [_err("sdk_schema", f"{path}: entry[0] must be "
                     "[l_feats, a_feats, v_feats]")]
    checks = [("audio", audio, a_names, feats[1], dims[1]),
              ("video", video, v_names, feats[2], dims[2])]
    if text != "text":
        checks.append(("text", text, l_names, feats[0], dims[0]))
    for mod, val, names, slot_list, dim_table in checks:
        idx = names.index(val)
        if idx >= len(slot_list):
            out.append(_err("sdk_slot_missing",
                            f"{path}: {mod} slot {idx} ({val}) absent — "
                            f"pickle has {len(slot_list)} {mod} slots"))
            continue
        arr = np.asarray(slot_list[idx])
        want = dim_table[val]
        if arr.ndim != 2 or arr.shape[1] != want:
            out.append(_err(
                "sdk_feature_dim",
                f"{path}: {mod} feature {val!r} has shape {arr.shape}, "
                f"expected [T, {want}] (registry table, ref Config.py)"))
    if name == "pom":
        if np.asarray(entry[1]).reshape(-1).shape[0] != 18:
            out.append(_err("sdk_pom_label",
                            f"{path}: POM label must have 18 columns"))
    return out


def check_avec_pickle(path: str) -> List[Finding]:
    data, err = _load(path)
    if err:
        return [err]
    if not isinstance(data, list) or not data:
        return [_err("avec_schema", f"{path}: expected a non-empty list")]
    return []


# ---------------------------------------------------------------- bert


def check_vocab(path: Optional[str]) -> List[Finding]:
    if not path:
        return [_warn("vocab_missing",
                      "--bert_vocab not given: the tokenizer will HASH "
                      "words into buckets — fine for smoke tests, "
                      "meaningless for accuracy parity")]
    if not os.path.exists(path):
        return [_err("vocab_not_found", f"--bert_vocab {path!r} missing")]
    with open(path, encoding="utf-8") as f:
        tokens = [line.rstrip("\n") for line in f]
    out = []
    for special in ("[PAD]", "[UNK]", "[CLS]", "[SEP]"):
        if special not in tokens[:1000]:
            out.append(_err("vocab_specials",
                            f"{path}: special token {special} not found "
                            "in the first 1000 entries — not a BERT "
                            "vocab.txt?"))
    if len(tokens) < 1000:
        out.append(_warn("vocab_small",
                         f"{path}: only {len(tokens)} tokens "
                         "(bert-base-uncased has 30522)"))
    return out


def check_bert_weights(path: Optional[str], hidden: int) -> List[Finding]:
    if not path:
        return [_warn("weights_missing",
                      "--bert_weights not given: BERT starts from RANDOM "
                      "init — accuracy vs the paper is meaningless")]
    if not os.path.exists(path):
        return [_err("weights_not_found",
                     f"--bert_weights {path!r} missing")]
    try:
        import torch

        sd = torch.load(path, map_location=resolve_device("cpu"),
                        weights_only=True)
    except Exception as e:
        return [_err("weights_unreadable", f"{path}: {e!r}")]
    key = next((k for k in sd if k.endswith(
        "embeddings.word_embeddings.weight")), None)
    if key is None:
        return [_err("weights_schema",
                     f"{path}: no *embeddings.word_embeddings.weight key "
                     "— not a BERT torch state dict?")]
    width = sd[key].shape[1]
    if width != hidden:
        return [_err("weights_hidden_mismatch",
                     f"{path}: embedding width {width} != --bert_hidden "
                     f"{hidden}")]
    return []


# ---------------------------------------------------------------- driver


def run_preflight(dataset: str, data_dir: str, text: str = "text",
                  audio: str = "covarep", video: str = "facet42",
                  bert_vocab: Optional[str] = None,
                  bert_weights: Optional[str] = None,
                  bert_hidden: int = 768) -> List[Finding]:
    findings = check_files(dataset, data_dir)
    if not any(f.level == "error" for f in findings):
        for path in expected_files(dataset, data_dir):
            if "Dec" in dataset:
                findings += check_dec_pickle(dataset, path)
            elif "SDK" in dataset:
                findings += check_sdk_pickle(dataset, path, text, audio,
                                             video)
            elif dataset == "avec2019":
                findings += check_avec_pickle(path)
    raw_text = ("Dec" in dataset or text == "text")
    if raw_text:
        findings += check_vocab(bert_vocab)
        findings += check_bert_weights(bert_weights, bert_hidden)
    return findings


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        description="Validate real-data inputs before a run "
                    "(docs/RUNBOOK.md)")
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--data_dir", required=True)
    ap.add_argument("--text", default="text")
    ap.add_argument("--audio", default="covarep")
    ap.add_argument("--video", default="facet42")
    ap.add_argument("--bert_vocab", default=None)
    ap.add_argument("--bert_weights", default=None)
    ap.add_argument("--bert_hidden", type=int, default=768)
    args = ap.parse_args(argv)
    findings = run_preflight(args.dataset, args.data_dir, args.text,
                             args.audio, args.video, args.bert_vocab,
                             args.bert_weights, args.bert_hidden)
    for f in findings:
        print(f)
    errors = [f for f in findings if f.level == "error"]
    if errors:
        print(f"preflight: {len(errors)} error(s) — fix before running.")
        raise SystemExit(1)
    print("preflight: OK")
    return findings


if __name__ == "__main__":
    main()
