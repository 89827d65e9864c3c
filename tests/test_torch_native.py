"""The native data-IO bindings (``dc_tts_tpu_torch/data/native.py``, built
from ``native/dataio.cpp`` at first use): wav decoding against scipy, and
the C++ loader's batches against the port's ``TrainLoader`` on a seeded
synthetic corpus."""
import os

import numpy as np
import pytest
from scipy.io import wavfile

from dc_tts_tpu_torch.config import test_config
from dc_tts_tpu_torch.data import dataset as TD
from dc_tts_tpu_torch.data import native
from dc_tts_tpu_torch.data.synthetic import make_corpus

CFG = test_config()
TEXTS = ["the cat sat", "a dog ran far", "big red hat", "sun is up",
         "go home now", "it is cold"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    data = make_corpus(str(root / "data"), TEXTS,
                       [0.05 + 0.01 * i for i in range(len(TEXTS))],
                       CFG.sr, seed=3)
    feats = str(root / "feats")
    TD.prepro_corpus(CFG.replace(data=data), feats, progress=False)
    return data, feats, TD.load_dataset_index(CFG, feats, data)


def test_builds_into_the_package_build_dir():
    assert native.available()
    assert native.library_path().startswith(native.BUILD_DIR)
    assert os.path.exists(native.library_path())


def test_wav_decode_matches_scipy(corpus, tmp_path):
    """16-bit PCM (the corpus) reads as x / 32768, float32 as written."""
    path = os.path.join(corpus[0], "wavs", "LJ000-0000.wav")
    y, sr = native.read_wav(path)
    sr2, pcm = wavfile.read(path)
    assert sr == sr2 == CFG.sr and pcm.dtype == np.int16
    np.testing.assert_array_equal(y, pcm.astype(np.float32) / 32768.0)
    f32 = np.random.default_rng(0).uniform(-1, 1, 999).astype(np.float32)
    wavfile.write(str(tmp_path / "f.wav"), 16000, f32)
    y, sr = native.read_wav(str(tmp_path / "f.wav"))
    assert sr == 16000
    np.testing.assert_array_equal(y, f32)
    with pytest.raises(IOError):
        native.read_wav(str(tmp_path / "missing.wav"))


def test_loader_batches_equal_train_loader(corpus):
    """One epoch of each loader (their shuffles differ): every example's
    row of a native batch equals its row in TrainLoader's batches."""
    _, feats, examples = corpus
    with native.NativeTrainLoader(CFG, examples, feats, batch_size=2,
                                  num_threads=1, seed=0) as nl:
        got = list(nl.batches(3))
    loader = TD.TrainLoader(CFG, examples, feats, batch_size=2,
                            num_threads=1, seed=0)
    want = {}
    for b in loader.batches(3):
        for i in range(2):
            want[tuple(b["texts"][i])] = {k: v[i] for k, v in b.items()}
    loader.stop()
    assert len(want) == len(TEXTS)
    seen = set()
    for b in got:
        assert {k: (v.shape, v.dtype) for k, v in b.items()} == {
            "texts": ((2, CFG.max_N), np.int32),
            "mels": ((2, CFG.max_T, CFG.n_mels), np.float32),
            "mags": ((2, CFG.max_T * CFG.r, CFG.n_freq), np.float32),
            "text_lens": ((2,), np.int32), "mel_lens": ((2,), np.int32)}
        for i in range(2):
            key = tuple(b["texts"][i])
            seen.add(key)
            for k, v in want[key].items():
                np.testing.assert_array_equal(b[k][i], v, err_msg=k)
    assert seen == set(want)
