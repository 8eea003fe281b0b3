"""Convert the reference's Megatron (torch) checkpoints into the port's
checkpoints, directly: Megatron state dict -> the port's ``state_dict``
keys, written as ``<output>/iter_*/state.pt`` with the tracker
(``training/checkpointing.py``). The key map and the QKV layout rules are
those of ``emdr2_tpu/tools/convert_reference_checkpoint.py``.

Layouts (``--kind``, ``auto`` tells them apart by their keys):

- ``emdr2``: model = {'encoder/t5_model', 'retriever/biencoder_model'} ->
  ``reader.*`` and ``retriever.*`` (an ``EMDR2Model``);
- ``t5``: model = {'language_model' with a decoder, 'lm_head'} ->
  ``reader.*``;
- ``dualencoder``: model = {'query_model', 'context_model'} ->
  ``retriever.*``;
- ``bert``: one BERT ``language_model``, cloned into both towers ->
  ``retriever.*`` (starting DPR from a BERT checkpoint);
- ``bert-pretrain``: a BERT with its pretraining heads -> the keys of
  ``models.bert.BertPretrainModel`` (``bert.*``, ``lm_dense``,
  ``lm_layernorm``, ``lm_bias``, and ``pooler`` + ``binary_head`` when the
  checkpoint has a binary head).

Layout rules:

- torch Linear weights are [out, in]; the port's ``Dense`` computes
  ``x @ W`` with W [in, out], so every weight is transposed;
- Megatron's fused QKV output dim is [head, head_dim, qkv] for
  ``checkpoint_version`` >= 1 and [qkv, head, head_dim] for version 0; the
  port's fused kernel is [D, q | k | v] with each part [head, head_dim]; the
  cross-attention's fused KV likewise with (k, v);
- pre-LN names: input_layernorm -> ln_self, post_attention_layernorm ->
  ln_cross (decoder) or ln_mlp (encoder), post_inter_attention_layernorm ->
  ln_mlp (decoder), final_layernorm -> ln_final.

Loading: Megatron checkpoints pickle an ``argparse.Namespace`` (the run's
arguments) beside the tensors. The file is read with
``torch.load(weights_only=True)`` after
``torch.serialization.add_safe_globals([argparse.Namespace])``, so nothing
but tensors, containers and that Namespace is unpickled. A checkpoint that
pickles other objects (older Megatron RNG states, say) is refused; pass
``--trust-pickle`` to read it with ``weights_only=False``, which runs the
file's pickled code: only for a file you trust.

Usage:
  python -m emdr2_tpu_torch.tools.convert_reference_checkpoint \\
      --input <reference ckpt .pt or iter dir> --output <checkpoint dir> \\
      [--kind auto|emdr2|t5|dualencoder|bert|bert-pretrain]
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict

import numpy as np
import torch

KINDS = ("auto", "emdr2", "t5", "dualencoder", "bert", "bert-pretrain")


def _np(t) -> np.ndarray:
    return np.asarray(t.detach().to("cpu").float().numpy())


def _qkv_to_ours(w: np.ndarray, num_heads: int, n_split: int,
                 version: int) -> np.ndarray:
    """Megatron fused [n_split*H, H_in] weight -> [q | k | v] order, still
    [out, in]."""
    out_dim, in_dim = w.shape
    if version == 0:
        return w  # already [qkv, head, hd] outermost
    hn = out_dim // n_split // num_heads
    w = w.reshape(num_heads, hn, n_split, in_dim)
    return np.transpose(w, (2, 0, 1, 3)).reshape(out_dim, in_dim)


def _qkv_bias_to_ours(b: np.ndarray, num_heads: int, n_split: int,
                      version: int) -> np.ndarray:
    if version == 0:
        return b
    hn = b.shape[0] // n_split // num_heads
    return np.transpose(b.reshape(num_heads, hn, n_split),
                        (2, 0, 1)).reshape(-1)


class _Out:
    """The converted state dict, filled key by key (fp32 tensors)."""

    def __init__(self):
        self.sd: Dict[str, torch.Tensor] = {}

    def put(self, key: str, a: np.ndarray) -> None:
        # a copy: a view would alias the input checkpoint's tensors (and
        # the two towers of a cloned BERT each other)
        self.sd[key] = torch.from_numpy(np.array(a, dtype=np.float32,
                                                 order="C", copy=True))

    def linear(self, sd: Dict, src: str, dst: str) -> None:
        self.put(f"{dst}.kernel", _np(sd[f"{src}.weight"]).T)
        if f"{src}.bias" in sd:
            self.put(f"{dst}.bias", _np(sd[f"{src}.bias"]))

    def fused(self, sd: Dict, src: str, dst: str, num_heads: int,
              n_split: int, version: int) -> None:
        w = _qkv_to_ours(_np(sd[f"{src}.weight"]), num_heads, n_split,
                         version)
        self.put(f"{dst}.kernel", w.T)
        self.put(f"{dst}.bias", _qkv_bias_to_ours(
            _np(sd[f"{src}.bias"]), num_heads, n_split, version))

    def ln(self, sd: Dict, src: str, dst: str) -> None:
        self.put(f"{dst}.weight", _np(sd[f"{src}.weight"]))
        self.put(f"{dst}.bias", _np(sd[f"{src}.bias"]))


def _flatten_module_sd(sd) -> Dict:
    """Torch state dicts may arrive nested or flat; -> flat dotted keys."""
    flat = {}

    def rec(prefix, node):
        if hasattr(node, "keys") and not hasattr(node, "shape"):
            for k, v in node.items():
                rec(f"{prefix}.{k}" if prefix else str(k), v)
        else:
            flat[prefix] = node

    rec("", sd)
    return flat


def _stack(out: _Out, sd: Dict, prefix: str, num_layers: int,
           num_heads: int, version: int, has_cross: bool) -> None:
    """A ParallelTransformer state dict (flat dotted keys) -> the keys of a
    ``TransformerStack`` under ``prefix``."""
    for i in range(num_layers):
        p = f"layers.{i}"
        d = f"{prefix}layer_{i}"
        # the reference names the module ``self_attention``; old Megatron
        # dumps used ``attention``
        attn = (f"{p}.self_attention"
                if f"{p}.self_attention.query_key_value.weight" in sd
                else f"{p}.attention")
        out.ln(sd, f"{p}.input_layernorm", f"{d}.ln_self")
        out.fused(sd, f"{attn}.query_key_value", f"{d}.self_attention.qkv",
                  num_heads, 3, version)
        out.linear(sd, f"{attn}.dense", f"{d}.self_attention.out")
        if has_cross:
            out.ln(sd, f"{p}.post_attention_layernorm", f"{d}.ln_cross")
            out.ln(sd, f"{p}.post_inter_attention_layernorm", f"{d}.ln_mlp")
            out.linear(sd, f"{p}.inter_attention.query",
                       f"{d}.cross_attention.query")
            out.fused(sd, f"{p}.inter_attention.key_value",
                      f"{d}.cross_attention.key_value", num_heads, 2,
                      version)
            out.linear(sd, f"{p}.inter_attention.dense",
                       f"{d}.cross_attention.out")
        else:
            out.ln(sd, f"{p}.post_attention_layernorm", f"{d}.ln_mlp")
        out.linear(sd, f"{p}.mlp.dense_h_to_4h", f"{d}.mlp.wi")
        out.linear(sd, f"{p}.mlp.dense_4h_to_h", f"{d}.mlp.wo")
    out.ln(sd, "final_layernorm", f"{prefix}ln_final")


def _bert(out: _Out, lm_sd: Dict, prefix: str, num_layers: int,
          num_heads: int, version: int) -> None:
    """The language_model of a BERT -> ``BertEncoder`` keys under
    ``prefix``."""
    flat = _flatten_module_sd(lm_sd)
    for name in ("word_embeddings", "position_embeddings",
                 "tokentype_embeddings"):
        key = f"embedding.{name}.weight"
        if key in flat:
            out.put(f"{prefix}embeddings.{name}", _np(flat[key]))
    enc = {k[len("encoder."):]: v for k, v in flat.items()
           if k.startswith("encoder.")}
    _stack(out, enc, f"{prefix}encoder.", num_layers, num_heads, version,
           has_cross=False)


def _t5(out: _Out, t5_sd: Dict, prefix: str, num_layers: int, num_heads: int,
        version: int) -> None:
    flat = _flatten_module_sd(t5_sd)
    lm = {k[len("language_model."):]: v for k, v in flat.items()
          if k.startswith("language_model.")}
    for name in ("word_embeddings", "position_embeddings"):
        out.put(f"{prefix}shared_embeddings.{name}",
                _np(lm[f"embedding.{name}.weight"]))
    for part, cross in (("encoder", False), ("decoder", True)):
        sub = {k[len(part) + 1:]: v for k, v in lm.items()
               if k.startswith(part + ".")}
        _stack(out, sub, f"{prefix}{part}.", num_layers, num_heads, version,
               has_cross=cross)
    out.put(f"{prefix}lm_bias", _np(flat["lm_head.bias"]))


def _bert_pretrain(out: _Out, model_sd: Dict, num_layers: int,
                   num_heads: int, version: int) -> None:
    flat = _flatten_module_sd(model_sd)
    _bert(out, model_sd["language_model"], "bert.", num_layers, num_heads,
          version)
    out.linear(flat, "lm_head.dense", "lm_dense")
    out.ln(flat, "lm_head.layernorm", "lm_layernorm")
    out.put("lm_bias", _np(flat["lm_head.bias"]))
    if "binary_head.weight" in flat:
        out.linear(flat, "language_model.pooler.dense", "pooler")
        out.linear(flat, "binary_head", "binary_head")


def _kind(model: Dict) -> str:
    if "encoder/t5_model" in model or "retriever/biencoder_model" in model:
        return "emdr2"
    if "query_model" in model or "context_model" in model:
        return "dualencoder"
    if "language_model" in model:
        # T5 checkpoints have a decoder inside the language model
        return "t5" if "decoder" in model["language_model"] else "bert"
    return "bert"


def convert_checkpoint(ckpt: Dict, kind: str = "auto", num_layers: int = 12,
                       num_heads: int = 12) -> Dict[str, torch.Tensor]:
    """A reference checkpoint dict -> the port's state_dict (fp32): the
    ``reader.*`` / ``retriever.*`` keys of an ``EMDR2Model`` (whichever
    halves the checkpoint holds), or a ``BertPretrainModel``'s keys."""
    model = ckpt.get("model", ckpt)
    # version 0 is a real value: its QKV slabs are laid out differently
    version = ckpt.get("checkpoint_version", None)
    version = 3 if version is None else int(version)
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    if kind == "auto":
        kind = _kind(model)
    out = _Out()
    args = (num_layers, num_heads, version)
    if kind == "bert":
        lm = model.get("language_model", model)
        for tower in ("query_model", "context_model"):
            _bert(out, lm, f"retriever.{tower}.", *args)
    elif kind == "bert-pretrain":
        _bert_pretrain(out, model, *args)
    elif kind == "t5":
        _t5(out, model, "reader.", *args)
    else:
        if kind == "emdr2":
            if "encoder/t5_model" in model:
                _t5(out, model["encoder/t5_model"], "reader.", *args)
            de = model.get("retriever/biencoder_model")
        else:
            de = model
        if de is not None:
            for tower in ("query_model", "context_model"):
                _bert(out, de[tower]["language_model"],
                      f"retriever.{tower}.", *args)
    return out.sd


def load_reference(path: str, trust_pickle: bool = False) -> Dict:
    """Read a reference checkpoint (``.pt``, or an ``iter_*`` directory
    holding ``model_optim_rng.pt`` or ``mp_rank_00/model_optim_rng.pt``)."""
    if os.path.isdir(path):
        for cand in ("model_optim_rng.pt", "mp_rank_00/model_optim_rng.pt"):
            full = os.path.join(path, cand)
            if os.path.exists(full):
                path = full
                break
    if trust_pickle:
        return torch.load(path, map_location="cpu", weights_only=False)
    torch.serialization.add_safe_globals([argparse.Namespace])
    return torch.load(path, map_location="cpu", weights_only=True)


def main(argv=None) -> int:
    from emdr2_tpu_torch.training import checkpointing as ck

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--input", required=True,
                   help=".pt file or reference iter_*/mp_rank_00 dir")
    p.add_argument("--output", required=True, help="checkpoint root")
    p.add_argument("--kind", default="auto", choices=KINDS)
    p.add_argument("--num-layers", type=int, default=12)
    p.add_argument("--num-attention-heads", type=int, default=12)
    p.add_argument("--trust-pickle", action="store_true",
                   help="unpickle arbitrary objects (weights_only=False): "
                        "only for a file you trust")
    args = p.parse_args(argv)

    ckpt = load_reference(args.input, args.trust_pickle)
    sd = convert_checkpoint(ckpt, args.kind, args.num_layers,
                            args.num_attention_heads)
    iteration = int(ckpt.get("iteration", 0))
    path = ck.write_payload(args.output, iteration,
                            {"model": sd, "step": iteration})
    halves = sorted({k.split(".")[0] for k in sd})
    print(f"converted {args.input} ({len(sd)} tensors: {halves}) -> {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
