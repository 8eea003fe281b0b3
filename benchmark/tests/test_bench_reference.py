"""The plain reference against the port's plain path on the CPU, at a tiny
configuration with dropout on: the BERT tower, the T5 FiD reader, the
counter-hash masks, the losses and the optimizer, the int8 rows and the
passage formatting. Both sides compute in float32 here, so they agree to
rounding; on the card the port computes in bf16 and the harness's limits
take that up."""

import numpy as np
import pytest
import torch

from benchmark import world
from benchmark.program import emdr2_config
from benchmark.reference import formatting, model, search, train
from benchmark.tests import tiny


@pytest.fixture(scope="module")
def cfg():
    return tiny.openqa()["config"]


def _port_model(cfg, weights):
    from emdr2_tpu_torch.models.emdr2 import EMDR2Model
    m = EMDR2Model(emdr2_config(cfg), device="cpu",
                   generator=torch.Generator().manual_seed(0))
    m.load_state_dict(weights, strict=True)
    return m


def test_param_specs_name_every_port_parameter(cfg):
    weights = model.make_params(cfg, 3, "cpu")
    port = _port_model(cfg, weights)
    assert list(port.state_dict()) == [n for n, _, _ in
                                       model.param_specs(cfg)]
    for n, t in port.state_dict().items():
        assert torch.equal(t, weights[n]), n


def test_make_params_repeats_and_scales(cfg):
    a = model.make_params(cfg, 11, "cpu")
    b = model.make_params(cfg, 11, "cpu")
    assert all(torch.equal(a[n], b[n]) for n in a)
    out = a["reader.encoder.layer_0.mlp.wo.kernel"]
    std = cfg["reader"]["init_std"] / np.sqrt(2 * cfg["reader"]["num_layers"])
    assert abs(float(out.std()) / std - 1) < 0.1
    bias = a["reader.lm_bias"]
    assert torch.equal(bias, torch.zeros_like(bias))


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_hidden_dropout_matches_packed_dropout(rate):
    from emdr2_tpu_torch.ops.hashing import packed_dropout
    x = torch.randn(5, 7, 9)
    for seed, row0 in ((3, 0), (0xDEADBEEF, 5)):
        want = packed_dropout(x, rate, seed, row_offset=row0)
        got = model.hidden_dropout(x, rate, seed, row0)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)


def test_attention_keep_matches_kernel_mask():
    from emdr2_tpu_torch.ops.hashing import keep_mask
    seed, B, nh, Lq, chunk = 0x1234567, 3, 2, 5, 4
    got = model.attention_keep(seed, 0.1, 2, B, nh, Lq, 3 * chunk, chunk,
                               "cpu")
    bh = torch.arange(2 * nh, (2 + B) * nh).view(B, nh)
    for j in range(3):
        want = keep_mask(seed, bh, 0.1, Lq, chunk, j)
        assert torch.equal(got[..., j * chunk:(j + 1) * chunk], want)


def test_seeds_match_dropout_seeds():
    from emdr2_tpu_torch.ops.hashing import DropoutSeeds, fold_seed
    for seed in (0, 7, 2 ** 31 + 5, 2 ** 40 + 3):
        for step in (0, 1, 2):
            ours = model.step_seeds(seed, step).fold(3).fold(1)
            theirs = DropoutSeeds(fold_seed(seed, step)).fold(3).fold(1)
            assert ours.seed == theirs.seed
            assert ours.site(4) == theirs.site(4)


def test_bert_tower_matches_port(cfg):
    from emdr2_tpu_torch.ops.hashing import DropoutSeeds
    weights = model.make_params(cfg, 5, "cpu")
    port = _port_model(cfg, weights)
    ids = torch.randint(104, 400, (6, 16))
    ids[:, 0], ids[:, 12:] = world.CLS, 0
    seeds = model.Seeds(99)
    got = model.bert_cls(weights, "retriever.context_model.", ids,
                         cfg["retriever"], seeds, model.Numerics())
    want = port.retriever.context_model.embed(ids, drop=DropoutSeeds(99))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_fid_reader_matches_port(cfg):
    from emdr2_tpu_torch.data import masks
    from emdr2_tpu_torch.ops.hashing import DropoutSeeds
    weights = model.make_params(cfg, 6, "cpu")
    port = _port_model(cfg, weights)
    B, K, Lr = 2, 4, cfg["reader_seq_len"]
    ids = torch.randint(104, 400, (B, K, Lr))
    ids[..., 40:] = 0
    dec = torch.randint(104, 400, (B, 8))
    dec[1, 5:] = 0
    d = DropoutSeeds(1234)
    with torch.no_grad():
        enc, flat = port.fid_encode(ids, d.fold(1))
        want = port.reader.decode(dec, enc, masks.attention_mask(dec, flat),
                                  d.fold(2))
    s = model.Seeds(1234)
    tc = cfg["reader"]
    got_enc = model.t5_encode(weights, ids.view(B * K, Lr), tc, s.fold(1),
                              model.Numerics())
    torch.testing.assert_close(got_enc.view(B, K * Lr, -1), enc, rtol=1e-4,
                               atol=1e-4)
    got = model.t5_decode(weights, dec, got_enc.view(B, K * Lr, -1),
                          ids.view(B, K * Lr), tc, s.fold(2),
                          model.Numerics())
    real = dec >= 1
    torch.testing.assert_close(got[real], want[real], rtol=1e-4, atol=1e-4)


def test_learning_rate_matches_schedule(cfg):
    from emdr2_tpu_torch.training.schedules import schedule_from_config
    opt = dict(cfg["optimizer"], train_iters=1000)
    sched = schedule_from_config(emdr2_config(
        dict(cfg, optimizer=opt)).train.optimizer, 1000)
    for step in (0, 1, 5, 10, 11, 500, 999, 2000):
        assert train.learning_rate(opt, step) == pytest.approx(sched(step),
                                                               rel=1e-6)


def test_adamw_matches_port_optimizer(cfg):
    from emdr2_tpu_torch.training.step import make_optimizer
    weights = model.make_params(cfg, 8, "cpu")
    port = _port_model(cfg, weights)
    opt_cfg = dict(cfg["optimizer"], train_iters=10, warmup=0.0)
    popt = make_optimizer(port, emdr2_config(
        dict(cfg, optimizer=opt_cfg)).train.optimizer, 10)
    p = {n: t.clone().requires_grad_(True) for n, t in weights.items()}
    ropt = train.AdamW(p, opt_cfg)
    gen = torch.Generator().manual_seed(0)
    for _ in range(3):
        for n, t in port.named_parameters():
            g = torch.randn(t.shape, generator=gen) * 0.01
            t.grad = g.clone()
            p[n].grad = g.clone()
        want = float(popt.step())
        got, _ = ropt.step()
        assert got == pytest.approx(want, rel=1e-5)
    for n, t in port.named_parameters():
        torch.testing.assert_close(p[n].detach(), t.detach(), rtol=1e-5,
                                   atol=1e-7)


def test_int8_rows_match_port_quantization():
    from emdr2_tpu_torch.ops.mips import dequantize_int8, quantize_int8
    rows = torch.randn(256, 16)
    rows[64:72] = 0.0
    q, scales = quantize_int8(rows, 8)
    torch.testing.assert_close(search.quantize_rows(rows, 8),
                               dequantize_int8(q, scales, 8))


def test_formatting_matches_port_postprocess(tmp_path):
    from emdr2_tpu_torch.data.evidence import EvidenceCorpus
    from emdr2_tpu_torch.data.postprocess import postprocess_retrieved_python
    o = tiny.openqa()
    cfg, traffic = o["config"], o["traffic"]
    # the plain Python path: passages long enough to fill and cut rows
    traffic.update(title_group=[1, 4], passage_tokens=[20, 40])
    c = world.make_corpus(cfg, traffic, 4, str(tmp_path))
    ev = EvidenceCorpus.load(c.text_prefix, c.title_prefix)
    ref = formatting.Corpus(c.texts, c.titles, c.group_of)
    q = world.make_questions(cfg, traffic, 4, 0)
    ids = world.special_ids(cfg)
    hits = np.random.default_rng(0).integers(1, cfg["num_passages"] + 1,
                                             size=(2, 30))
    for Lr in (48, 160):
        want = postprocess_retrieved_python(
            q.uid, q.ids, q.length, hits, ev, 30, cfg["context_seq_len"], Lr,
            ids["cls"], ids["sep"], ids["pad"])
        got = formatting.format_step(ref, q.ids, q.length, q.uid, hits, 30,
                                     cfg["context_seq_len"], Lr, ids["cls"],
                                     ids["sep"], ids["pad"])
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_corpus_files_read_back(tmp_path):
    from emdr2_tpu_torch.data.evidence import EvidenceCorpus
    o = tiny.embed()
    c = world.make_corpus(o["config"], o["traffic"], 9, str(tmp_path))
    ev = EvidenceCorpus.load(c.text_prefix, c.title_prefix)
    assert len(ev) == o["config"]["num_passages"]
    for doc in (1, 7, len(ev)):
        assert ev.doc_tokens(doc) == c.texts[doc - 1].tolist()
        assert ev.title_tokens(doc) == c.titles[doc - 1].tolist()
