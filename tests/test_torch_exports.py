"""Every name the JAX package's ``__init__.py`` files export is exported
by the port's package of the same name, or is on the list of names the port
does not owe (ROADMAP.md, "Not owed"), each with its reason."""
import importlib
import inspect

import pytest

SUBPACKAGES = ("", ".data", ".dsp", ".models", ".ops", ".parallel", ".train",
               ".utils")

NOT_OWED = {
    # in the port these names are the submodules dsp.stft and
    # dsp.griffin_lim, which the functions would hide
    ".dsp": {"stft", "griffin_lim"},
    # the Pallas interpret-mode switch, and the TPU core's VMEM gate (the
    # CUDA kernel takes every HC shape)
    ".ops": {"pallas_supported", "default_interpret", "hc_train_fits"},
    # JAX NamedSharding constructors: a rank holds plain tensors
    ".parallel": {"data_sharding", "replicated_sharding"},
    # optax transformations (the port: noam_lr, apply_updates) and the two
    # JAX state types (the port: one TrainState)
    ".train": {"noam_schedule", "make_optimizer", "Text2MelTrainState",
               "SSRNTrainState"},
}


def _exports(pkg):
    mod = importlib.import_module(pkg)
    return sorted(n for n in vars(mod) if not n.startswith("_")
                  and not inspect.ismodule(getattr(mod, n))
                  or n in ("__version__", "checkpoint"))


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_every_jax_export_is_ported_or_not_owed(sub):
    jax_names = _exports("dc_tts_tpu" + sub)
    port = importlib.import_module("dc_tts_tpu_torch" + sub)
    not_owed = NOT_OWED.get(sub, set())
    assert not_owed <= set(jax_names), "a stale not-owed name"
    missing = [n for n in jax_names
               if n not in not_owed and not hasattr(port, n)]
    assert not missing, f"dc_tts_tpu_torch{sub} lacks {missing}"
    for n in jax_names:
        obj = getattr(port, n, None)
        if n in not_owed:
            # absent, or (dsp) the port's submodule of that name
            assert obj is None or (inspect.ismodule(obj) and
                                   obj.__name__.startswith("dc_tts_tpu_torch"))
        elif n != "__version__":
            assert (inspect.getmodule(obj).__name__
                    .startswith("dc_tts_tpu_torch.")), n


def test_version_and_all():
    import dc_tts_tpu
    import dc_tts_tpu_torch
    assert dc_tts_tpu_torch.__version__ == dc_tts_tpu.__version__
    assert set(dc_tts_tpu.__all__) <= set(dc_tts_tpu_torch.__all__)
    for n in dc_tts_tpu_torch.__all__:
        assert hasattr(dc_tts_tpu_torch, n)
