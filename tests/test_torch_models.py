"""Parity of the PyTorch port's models with the JAX package (CPU, fp32).

The same flax parameters (converted by ``emdr2_tpu_torch.convert``) and the
same numpy inputs go through both packages at ``tiny_config`` with the
flash self-attention path on, after ``bf16_eval_params`` on both sides.
Tolerance: fp32 compute on both sides differing only in summation order,
atol 1e-4 on O(1) activations and log-probs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from emdr2_tpu.config import tiny_config as jax_tiny_config  # noqa: E402
from emdr2_tpu.models import EMDR2Model as JaxEMDR2Model  # noqa: E402
from emdr2_tpu.models.decoding import (  # noqa: E402
    DecoderSession as JaxDecoderSession,
    bf16_eval_params as jax_bf16_eval_params,
)
from emdr2_tpu_torch.config import tiny_config, with_flash_attention  # noqa: E402
from emdr2_tpu_torch.convert import params_from_jax  # noqa: E402
from emdr2_tpu_torch.models import EMDR2Batch, EMDR2Model  # noqa: E402
from emdr2_tpu_torch.models.decoding import (  # noqa: E402
    DecoderSession,
    _encode_chunk_k,
    bf16_eval_params,
)
from tests.test_models import make_batch  # noqa: E402

torch.set_num_threads(2)

ATOL = 1e-4


def jax_flash_cfg(cfg):
    enc = dataclasses.replace(cfg.retriever.encoder, fid_flash_attention=True)
    t5c = dataclasses.replace(cfg.reader.transformer,
                              fid_flash_attention=True)
    return cfg.replace(
        retriever=dataclasses.replace(cfg.retriever, encoder=enc),
        reader=dataclasses.replace(cfg.reader, transformer=t5c))


def unboxed_numpy(params):
    import flax.linen as nn
    return jax.tree_util.tree_map(np.asarray, nn.meta.unbox(params))


def torch_batch(batch) -> EMDR2Batch:
    return EMDR2Batch(*[torch.tensor(np.asarray(x)) for x in batch])


@pytest.fixture(scope="module")
def pair():
    """(jax cfg, jax model, bf16-eval jax params, port model, batch, fp32
    numpy params)."""
    jcfg = jax_flash_cfg(jax_tiny_config())
    jbatch = make_batch(jcfg)
    jmodel = JaxEMDR2Model(jcfg)
    params = jmodel.init({"params": jax.random.PRNGKey(0)}, jbatch)["params"]
    np_params = unboxed_numpy(params)
    model = EMDR2Model(with_flash_attention(tiny_config()), device="cpu")
    model.load_state_dict(params_from_jax(np_params), strict=True)
    bf16_eval_params(model)
    jparams = jax_bf16_eval_params(unboxed_numpy(params))
    return jcfg, jmodel, jparams, model.eval(), jbatch, np_params


class TestConvert:
    def test_round_trip(self, pair):
        """Every flax leaf lands in the port's state_dict with the
        documented layout change, and nothing is left over."""
        np_params = pair[-1]
        flat = {jax.tree_util.keystr(p, simple=True, separator="."): v
                for p, v in jax.tree_util.tree_flatten_with_path(
                    np_params)[0]}
        sd = params_from_jax(np_params)
        model = EMDR2Model(tiny_config(), device="cpu")
        assert set(sd) == set(model.state_dict())
        assert len(sd) == len(flat)
        for path, a in flat.items():
            key = path[:-len("scale")] + "weight" if path.endswith(
                ".scale") else path
            got = sd[key].numpy()
            if path.endswith("kernel") and a.ndim == 3:
                np.testing.assert_array_equal(got.reshape(a.shape), a)
                assert got.shape == (a.shape[0], a.shape[1] * a.shape[2])
            else:
                np.testing.assert_array_equal(got.reshape(a.shape), a)
        model.load_state_dict(sd, strict=True)

    def test_bf16_eval_params_matches_jax(self, pair):
        """The same leaves are cast (rank >= 2, not embeddings), with the
        same rounding."""
        _, _, jparams, model, _, _ = pair
        conv = params_from_jax(jax.tree_util.tree_map(
            lambda x: np.asarray(x, np.float32), jparams))
        for name, p in model.state_dict().items():
            want_bf16 = p.dim() >= 2 and "embeddings" not in name
            assert (p.dtype == torch.bfloat16) == want_bf16, name
            np.testing.assert_array_equal(p.float().numpy(),
                                          conv[name].numpy())


class TestModelParity:
    def test_embed_query(self, pair):
        jcfg, jmodel, jparams, model, jbatch, _ = pair
        want = jmodel.apply({"params": jparams}, jbatch.query_bert_ids,
                            method=JaxEMDR2Model.embed_query)
        with torch.inference_mode():
            got = model.embed_query(torch.tensor(
                np.asarray(jbatch.query_bert_ids)))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)

    def test_embed_context(self, pair):
        jcfg, jmodel, jparams, model, jbatch, _ = pair
        ids = np.array(jbatch.context_bert_ids)[:, 0]
        types = (np.arange(ids.shape[1]) > 5).astype(np.int32)[None].repeat(
            ids.shape[0], 0)
        want = jmodel.apply({"params": jparams}, jnp.asarray(ids),
                            jnp.asarray(types),
                            method=JaxEMDR2Model.embed_context)
        with torch.inference_mode():
            got = model.retriever.embed_context(torch.as_tensor(ids),
                                                torch.as_tensor(types))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)

    def test_plain_attention_path_without_flash(self, pair):
        """fid_flash_attention off: the materialized-score encoder path
        against the JAX package's XLA path."""
        _, _, jparams, model, jbatch, _ = pair
        jcfg = jax_tiny_config()
        jmodel = JaxEMDR2Model(jcfg)
        plain = EMDR2Model(tiny_config(), device="cpu")
        plain.load_state_dict(model.state_dict())
        ids = np.asarray(jbatch.reader_ids).copy()
        ids[1, 0, 30:] = 0
        want, _ = jmodel.apply({"params": jparams}, jnp.asarray(ids),
                               method=JaxEMDR2Model.fid_encode)
        wq = jmodel.apply({"params": jparams}, jbatch.query_bert_ids,
                          method=JaxEMDR2Model.embed_query)
        with torch.inference_mode():
            got, _ = plain.fid_encode(torch.as_tensor(ids))
            gq = plain.embed_query(torch.tensor(
                np.asarray(jbatch.query_bert_ids)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
        np.testing.assert_allclose(gq.numpy(), np.asarray(wq), atol=ATOL)

    def test_embed_query_padded(self, pair):
        """Padded question rows (the serving layout) agree as well."""
        jcfg, jmodel, jparams, model, _, _ = pair
        ids = np.random.RandomState(3).randint(
            2, 500, size=(3, jcfg.retriever.query_seq_len)).astype(np.int32)
        ids[0, 5:] = 0
        ids[1, 9:] = 0
        want = jmodel.apply({"params": jparams}, jnp.asarray(ids),
                            method=JaxEMDR2Model.embed_query)
        with torch.inference_mode():
            got = model.embed_query(torch.as_tensor(ids))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)

    def test_fid_encode(self, pair):
        jcfg, jmodel, jparams, model, jbatch, _ = pair
        ids = np.asarray(jbatch.reader_ids).copy()
        ids[0, 1, 20:] = 0           # padded reader rows
        want_h, want_ids = jmodel.apply({"params": jparams}, jnp.asarray(ids),
                                        method=JaxEMDR2Model.fid_encode)
        with torch.inference_mode():
            got_h, got_ids = model.fid_encode(torch.as_tensor(ids))
        np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
        np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h),
                                   atol=ATOL)

    def test_decode_step0_log_probs(self, pair):
        """One incremental step from BOS over the session's cross K/V."""
        jcfg, jmodel, jparams, model, jbatch, _ = pair
        bos = 7
        js = JaxDecoderSession(jmodel, jparams, jcfg.reader.decoder_seq_len)
        kvs, flat = js.encode(jbatch)
        cache = js.init_cache(flat.shape[0], kvs, flat)
        tok = np.full((flat.shape[0], 1), bos, np.int32)
        want, _ = js.step(cache, tok, kvs, flat, 0)

        sess = DecoderSession(model, jcfg.reader.decoder_seq_len)
        tkvs, tflat = sess.encode(torch_batch(jbatch))
        np.testing.assert_array_equal(tflat.numpy(), np.asarray(flat))
        with torch.inference_mode():
            logits = model.decode_step(torch.as_tensor(tok), tflat, tkvs,
                                       sess.new_cache(tflat.shape[0], "cpu"))
        got = torch.log_softmax(logits[:, -1].float(), dim=-1)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)

    def test_chunked_encode_matches_whole(self, pair):
        """K-block encoding (B*K over the row budget) is exact."""
        _, _, _, model, jbatch, _ = pair
        batch = torch_batch(jbatch)
        B, K = batch.reader_ids.shape[:2]
        assert _encode_chunk_k(B, K, B * K // 2) < K
        whole = DecoderSession(model, 4).encode(batch)
        blocks = DecoderSession(model, 4, encode_chunk_rows=B * K // 2
                                ).encode(batch)
        for (k1, v1), (k2, v2) in zip(whole[0], blocks[0]):
            torch.testing.assert_close(k1, k2, rtol=0, atol=1e-6)
            torch.testing.assert_close(v1, v2, rtol=0, atol=1e-6)
