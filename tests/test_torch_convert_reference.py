"""The port's reference-checkpoint tools (CPU):

- ``tools/convert_reference_checkpoint.py`` converts a synthetic Megatron
  state dict directly into the port's keys; the JAX converter followed by
  ``convert.params_from_jax`` must give the same tensors bit for bit, for
  the five layouts (EMDR2 joint, T5, dual encoder, one BERT cloned into
  both towers, BERT with its pretraining heads) and both QKV layouts
  (checkpoint versions 0 and >= 1). The converted dicts load strictly into
  the port's models, and ``BertPretrainModel`` then computes the JAX
  model's logits. ``main`` reads a ``.pt`` that pickles an
  ``argparse.Namespace`` without unpickling code.
- ``tools/checkpoint_surgery.py``: ``extract``, ``strip-optim``, ``prune``.
"""

import argparse
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from emdr2_tpu.config import tiny_config as jax_tiny_config  # noqa: E402
from emdr2_tpu.models.bert import (  # noqa: E402
    BertPretrainModel as JaxBertPretrainModel,
)
from emdr2_tpu.tools import convert_reference_checkpoint as jconv  # noqa: E402
from emdr2_tpu_torch.config import tiny_config  # noqa: E402
from emdr2_tpu_torch.convert import params_from_jax  # noqa: E402
from emdr2_tpu_torch.models import EMDR2Model  # noqa: E402
from emdr2_tpu_torch.models.bert import BertPretrainModel  # noqa: E402
from emdr2_tpu_torch.tools import checkpoint_surgery  # noqa: E402
from emdr2_tpu_torch.tools import convert_reference_checkpoint as conv  # noqa: E402
from emdr2_tpu_torch.training import checkpointing as ck  # noqa: E402
from emdr2_tpu_torch.training.step import TrainState, make_optimizer  # noqa: E402
from tests.test_convert import (  # noqa: E402
    make_megatron_bert,
    make_megatron_stack,
)

torch.set_num_threads(2)

L, H, F, NH, V, P, V_T5 = 2, 64, 128, 4, 512, 128, 640


def _t(rng, *shape):
    return torch.from_numpy(rng.randn(*shape).astype(np.float32))


def megatron_t5(rng):
    return {"language_model": {
                "embedding": {"word_embeddings": {"weight": _t(rng, V_T5, H)},
                              "position_embeddings": {"weight": _t(rng, P,
                                                                   H)}},
                "encoder": make_megatron_stack(L, H, F, NH, False, rng),
                "decoder": make_megatron_stack(L, H, F, NH, True, rng)},
            "lm_head": {"bias": _t(rng, V_T5)}}


def megatron_dual(rng):
    return {tower: {"language_model": make_megatron_bert(L, H, F, NH, V, P,
                                                         rng)}
            for tower in ("query_model", "context_model")}


def self_attention_names(sd):
    """The same stack under the reference's ``self_attention`` name."""
    return {k.replace(".attention.", ".self_attention."): v
            for k, v in sd.items()}


def megatron_bert_pretrain(rng, binary=True):
    lm = make_megatron_bert(L, H, F, NH, V, P, rng)
    lm["encoder"] = self_attention_names(lm["encoder"])
    sd = {"language_model": lm,
          "lm_head": {"dense": {"weight": _t(rng, H, H), "bias": _t(rng, H)},
                      "layernorm": {"weight": _t(rng, H),
                                    "bias": _t(rng, H)},
                      "bias": _t(rng, V)}}
    if binary:
        lm["pooler"] = {"dense": {"weight": _t(rng, H, H),
                                  "bias": _t(rng, H)}}
        sd["binary_head"] = {"weight": _t(rng, 2, H), "bias": _t(rng, 2)}
    return sd


def checkpoint(kind, version, rng):
    if kind == "emdr2":
        model = {"encoder/t5_model": megatron_t5(rng),
                 "retriever/biencoder_model": megatron_dual(rng)}
    elif kind == "t5":
        model = megatron_t5(rng)
    elif kind == "dualencoder":
        model = megatron_dual(rng)
    elif kind == "bert":
        model = {"language_model": make_megatron_bert(L, H, F, NH, V, P,
                                                      rng)}
    else:
        model = megatron_bert_pretrain(rng)
    return {"model": model, "checkpoint_version": version, "iteration": 7}


def jax_reference(ckpt, kind):
    if kind == "bert-pretrain":
        tree = jconv.convert_bert_pretrain(
            ckpt["model"], L, NH, ckpt["checkpoint_version"])
    else:
        tree = jconv.convert_checkpoint(ckpt, kind="auto", num_layers=L,
                                        num_heads=NH)
    return params_from_jax(tree)


@pytest.mark.parametrize("version", [0, 3])
@pytest.mark.parametrize("kind", ["emdr2", "t5", "dualencoder", "bert",
                                  "bert-pretrain"])
def test_direct_conversion_equals_jax_converter(kind, version):
    ckpt = checkpoint(kind, version, np.random.RandomState(0))
    auto = "bert-pretrain" if kind == "bert-pretrain" else "auto"
    got = conv.convert_checkpoint(ckpt, auto, num_layers=L, num_heads=NH)
    want = jax_reference(ckpt, kind)
    assert set(got) == set(want)
    for k, v in got.items():
        assert v.dtype == torch.float32 and v.is_contiguous(), k
        assert torch.equal(v, want[k]), k
    # the kind is what auto-detection says
    if kind != "bert-pretrain":
        assert conv._kind(ckpt["model"]) == kind


def test_converted_checkpoints_load_into_the_port_models():
    rng = np.random.RandomState(1)
    cfg = tiny_config()
    cfg = cfg.replace(reader=dataclasses.replace(
        cfg.reader, transformer=dataclasses.replace(
            cfg.reader.transformer, vocab_size=V_T5)))
    model = EMDR2Model(cfg, device="cpu")
    full = conv.convert_checkpoint(checkpoint("emdr2", 3, rng),
                                   num_layers=L, num_heads=NH)
    model.load_state_dict(full, strict=True)
    for kind in ("dualencoder", "bert"):
        sd = conv.convert_checkpoint(checkpoint(kind, 1, rng), num_layers=L,
                                     num_heads=NH)
        model.retriever.load_state_dict(
            {k[len("retriever."):]: v for k, v in sd.items()}, strict=True)
    bert = conv.convert_checkpoint(checkpoint("bert", 1, rng), num_layers=L,
                                   num_heads=NH)
    for k, v in bert.items():               # the towers are equal copies
        if k.startswith("retriever.query_model."):
            other = bert[k.replace("query_model", "context_model")]
            assert torch.equal(v, other) and v.data_ptr() != other.data_ptr()
    reader = conv.convert_checkpoint(checkpoint("t5", 0, rng), num_layers=L,
                                     num_heads=NH)
    model.reader.load_state_dict(
        {k[len("reader."):]: v for k, v in reader.items()}, strict=True)


@pytest.mark.parametrize("binary", [True, False])
def test_bert_pretrain_model_matches_jax(binary):
    """The converted BERT-pretrain checkpoint in both packages' models: the
    masked-LM logits and the binary head agree (fp32, atol 1e-4 on logits
    of size up to ~10)."""
    rng = np.random.RandomState(2)
    model_sd = megatron_bert_pretrain(rng, binary)
    jtree = jconv.convert_bert_pretrain(model_sd, L, NH, 3)
    jcfg = dataclasses.replace(jax_tiny_config().retriever.encoder,
                               vocab_size=V, max_position_embeddings=P)
    pcfg = dataclasses.replace(tiny_config().retriever.encoder,
                               vocab_size=V, max_position_embeddings=P)
    ids = np.random.RandomState(3).randint(2, V, size=(2, 10))
    ids[1, 6:] = 0
    types = np.zeros_like(ids)
    types[:, 4:] = 1
    jmodel = JaxBertPretrainModel(jcfg, add_binary_head=binary)
    want_lm, want_bin = jmodel.apply({"params": jtree}, jnp.asarray(ids),
                                     jnp.asarray(types))
    model = BertPretrainModel(pcfg, add_binary_head=binary, device="cpu")
    sd = conv.convert_checkpoint({"model": model_sd}, "bert-pretrain",
                                 num_layers=L, num_heads=NH)
    model.load_state_dict(sd, strict=True)
    with torch.no_grad():
        lm, bin_ = model(torch.tensor(ids), torch.tensor(types))
    assert lm.dtype == torch.float32
    np.testing.assert_allclose(lm.numpy(), np.asarray(want_lm), atol=1e-4)
    if binary:
        np.testing.assert_allclose(bin_.numpy(), np.asarray(want_bin),
                                   atol=1e-4)
    else:
        assert bin_ is None and want_bin is None


def test_main_reads_a_megatron_file_with_its_namespace(tmp_path, capsys):
    rng = np.random.RandomState(4)
    ckpt = checkpoint("dualencoder", 3, rng)
    ckpt["args"] = argparse.Namespace(hidden_size=H, num_layers=L)
    os.makedirs(tmp_path / "iter_0000007" / "mp_rank_00")
    path = tmp_path / "iter_0000007" / "mp_rank_00" / "model_optim_rng.pt"
    torch.save(ckpt, path)
    out = tmp_path / "converted"
    assert conv.main(["--input", str(tmp_path / "iter_0000007"),
                      "--output", str(out), "--num-layers", str(L),
                      "--num-attention-heads", str(NH)]) == 0
    assert "['retriever']" in capsys.readouterr().out
    assert ck.latest_iteration(str(out)) == 7
    cfg = tiny_config()
    model = EMDR2Model(cfg, device="cpu")
    ck.load_retriever_params(str(out), model.retriever)
    want = conv.convert_checkpoint(ckpt, num_layers=L, num_heads=NH)
    for k, v in model.retriever.state_dict().items():
        assert torch.equal(v, want["retriever." + k]), k


class Opaque:
    """A class no safe list holds."""


def test_main_refuses_other_pickled_objects_unless_trusted(tmp_path):
    ckpt = checkpoint("bert", 3, np.random.RandomState(5))
    ckpt["rng"] = Opaque()
    path = tmp_path / "ckpt.pt"
    torch.save(ckpt, path)
    with pytest.raises(Exception):
        conv.load_reference(str(path))
    assert "rng" in conv.load_reference(str(path), trust_pickle=True)


# ---------------------------------------------------------------- surgery

def _saved_emdr2(root, iterations=(3,)):
    cfg = tiny_config()
    model = EMDR2Model(cfg, device="cpu")
    state = TrainState(step=0, seed=1, model=model,
                       optimizer=make_optimizer(model, cfg.train.optimizer,
                                                10))
    for it in iterations:
        state.step = it
        ck.save_checkpoint(root, state, it)
    return cfg, model, state


def test_surgery_extract_retriever_and_reader(tmp_path):
    root = str(tmp_path / "run")
    cfg, model, _ = _saved_emdr2(root)
    for sub, loader in (("retriever", ck.load_retriever_params),
                        ("reader", ck.load_reader_params)):
        out = str(tmp_path / sub)
        assert checkpoint_surgery.main(["extract", "--load", root,
                                        "--submodel", sub,
                                        "--save", out]) == 0
        payload, it = ck.read_payload(out)
        assert it == 3 and payload["step"] == 3
        assert payload["model"] and all(
            k.startswith(sub + ".") for k in payload["model"])
        fresh = EMDR2Model(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(9))
        loader(out, getattr(fresh, sub))
        for k, v in getattr(model, sub).state_dict().items():
            assert torch.equal(v, getattr(fresh, sub).state_dict()[k]), k
    with pytest.raises(ValueError):
        checkpoint_surgery.extract(str(tmp_path / "retriever"), "reader",
                                   str(tmp_path / "none"))


def test_surgery_strip_optim(tmp_path):
    root, slim = str(tmp_path / "run"), str(tmp_path / "slim")
    cfg, model, _ = _saved_emdr2(root)
    assert checkpoint_surgery.main(["strip-optim", "--load", root,
                                    "--save", slim]) == 0
    payload, _ = ck.read_payload(slim)
    assert "optimizer" not in payload and "count" not in payload
    assert payload["step"] == 3
    fresh = EMDR2Model(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(9))
    fstate = TrainState(step=0, seed=0, model=fresh,
                        optimizer=make_optimizer(fresh, cfg.train.optimizer,
                                                 10))
    with pytest.raises(ValueError, match="optimizer"):
        ck.load_checkpoint(slim, fstate)
    ck.load_checkpoint(slim, fstate, load_optim=False)
    for k, v in model.state_dict().items():
        assert torch.equal(v, fresh.state_dict()[k]), k
    assert os.path.getsize(os.path.join(ck.iter_dir(slim, 3), ck.STATE_FILE)) \
        < os.path.getsize(os.path.join(ck.iter_dir(root, 3), ck.STATE_FILE))


def test_surgery_prune(tmp_path, capsys):
    root = str(tmp_path / "run")
    _saved_emdr2(root, iterations=(1, 2, 3, 4))
    assert checkpoint_surgery.main(["prune", "--load", root,
                                    "--keep", "2"]) == 0
    assert sorted(d for d in os.listdir(root) if d.startswith("iter_")) == [
        "iter_0000003", "iter_0000004"]
    assert ck.latest_iteration(root) == 4
    assert "pruned" in capsys.readouterr().out
