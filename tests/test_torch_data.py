"""The port's data path against the JAX package on a tiny seeded corpus:

* ``parse_transcript``, ``load_wav``, ``compute_bucket_shapes`` and the
  numpy features equal the JAX package's exactly;
* ``TrainLoader`` batches (same seed, one worker thread so the order is
  fixed) equal bit for bit, on the full grid, in buckets and on the fly;
* ``wav_to_spectrograms`` and ``prepro_corpus`` (torch.fft on the CPU)
  within 1e-4 of the JAX device path: the values are normalised dB in
  [0, 1], and a bin near the 1e-5 magnitude floor turns the two FFTs'
  relative rounding (~1e-5 there) into 8.7x that (20 / ln 10 / max_db);
* ``mel_filterbank`` against tests/goldens/mel_basis.npz at the golden
  test's 2e-7 x max.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dc_tts_tpu.config import test_config as jax_test_config
from dc_tts_tpu.data import dataset as JD
from dc_tts_tpu.dsp import audio as JA
from dc_tts_tpu.dsp import features as JF
from dc_tts_tpu.dsp import features_np as JFN

from dc_tts_tpu_torch.config import test_config
from dc_tts_tpu_torch.data import dataset as TD
from dc_tts_tpu_torch.data.synthetic import make_corpus
from dc_tts_tpu_torch.dsp import audio as TA
from dc_tts_tpu_torch.dsp import features as TF
from dc_tts_tpu_torch.dsp import features_np as TFN
from dc_tts_tpu_torch.dsp.mel import mel_filterbank

torch.set_num_threads(1)

CFG, JCFG = test_config(), jax_test_config()
TEXTS = ["the cat sat", "a dog ran far", "big red hat", "sun is up",
         "go home now", "it is cold", "we can go", "no way out",
         "red fox", "my hat"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    data = make_corpus(str(root / "data"), TEXTS,
                       [0.05 + 0.005 * i for i in range(len(TEXTS))],
                       CFG.sr, seed=3)
    feats = str(root / "feats")
    n = TD.prepro_corpus(CFG.replace(data=data), feats, progress=False)
    assert n == len(TEXTS)
    return data, feats


def test_parse_transcript_matches_jax(corpus):
    data, _ = corpus
    te, je = TD.parse_transcript(CFG, data), JD.parse_transcript(JCFG, data)
    assert [(e.fname, e.fpath) for e in te] == [(e.fname, e.fpath)
                                                for e in je]
    for a, b in zip(te, je):
        np.testing.assert_array_equal(a.text_ids, b.text_ids)


def test_wav_features_match_jax(corpus):
    data, _ = corpus
    for ex in TD.parse_transcript(CFG, data)[:4]:
        y = TA.load_wav(ex.fpath, CFG.sr)
        np.testing.assert_array_equal(y, JA.load_wav(ex.fpath, JCFG.sr))
        mel, mag = TF.wav_to_spectrograms(torch.as_tensor(y), CFG)
        jmel, jmag = JF.wav_to_spectrograms(jnp.asarray(y), JCFG)
        np.testing.assert_allclose(mel.numpy(), np.asarray(jmel), atol=1e-4)
        np.testing.assert_allclose(mag.numpy(), np.asarray(jmag), atol=1e-4)
        for a, b in zip(TFN.wav_to_spectrograms_np(y, CFG),
                        JFN.wav_to_spectrograms_np(y, JCFG)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(TF.reduce_mel(mel.numpy(), mag.numpy(), CFG.r),
                        JF.reduce_mel(mel.numpy(), mag.numpy(), CFG.r)):
            np.testing.assert_array_equal(a, b)


def test_prepro_matches_jax(corpus, tmp_path):
    data, feats = corpus
    JD.prepro_corpus(JCFG.replace(data=data), str(tmp_path), progress=False)
    for sub in ("mels", "mags"):
        names = sorted(os.listdir(os.path.join(feats, sub)))
        assert names == sorted(os.listdir(tmp_path / sub))
        for n in names:
            a = np.load(os.path.join(feats, sub, n))
            b = np.load(tmp_path / sub / n)
            assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
            np.testing.assert_allclose(a, b, atol=1e-4)


def test_mel_filterbank_matches_golden():
    with np.load(os.path.join(os.path.dirname(__file__), "goldens",
                              "mel_basis.npz")) as d:
        gold = d["basis_22050_2048_80"]
    ours = mel_filterbank(22050, 2048, 80)
    np.testing.assert_allclose(ours, gold, rtol=0, atol=2e-7 * gold.max())


@pytest.mark.parametrize("n_buckets", [2, 3])
@pytest.mark.parametrize("on_the_fly", [False, True])
def test_bucket_shapes_match_jax(corpus, n_buckets, on_the_fly):
    data, feats = corpus
    te, je = TD.parse_transcript(CFG, data), JD.parse_transcript(JCFG, data)
    assert TD.compute_bucket_shapes(CFG, te, feats, n_buckets,
                                    on_the_fly=on_the_fly) == \
        JD.compute_bucket_shapes(JCFG, je, feats, n_buckets,
                                 on_the_fly=on_the_fly)


@pytest.mark.parametrize("mode", ["grid", "buckets", "on_the_fly"])
def test_train_loader_batches_match_jax(corpus, mode):
    data, feats = corpus
    otf = mode == "on_the_fly"
    loaders = []
    for D, cfg in ((TD, CFG), (JD, JCFG)):
        cfg = cfg.replace(data=data, B=2)
        ex = D.load_dataset_index(cfg, feats, data, on_the_fly=otf)
        buckets = (D.compute_bucket_shapes(cfg, ex, feats, 2)
                   if mode == "buckets" else None)
        loaders.append(D.TrainLoader(cfg, ex, feats, seed=5, num_threads=1,
                                     buckets=buckets, on_the_fly=otf))
    t_batches = list(loaders[0].batches(7))
    j_batches = list(loaders[1].batches(7))
    for tb, jb in zip(t_batches, j_batches):
        assert sorted(tb) == sorted(jb)
        for k in tb:
            assert tb[k].dtype == jb[k].dtype, k
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)


def test_train_loader_raises_without_a_full_batch(corpus):
    data, feats = corpus
    cfg = CFG.replace(data=data, B=len(TEXTS) + 1)
    ex = TD.load_dataset_index(cfg, feats, data)
    with pytest.raises(ValueError, match="no full batch"):
        TD.TrainLoader(cfg, ex, feats)
