"""Reference (TF1) checkpoint converter, the port of
``dc_tts_tpu/convert.py``.

Maps the original graph's variable names to the port's parameter trees, so
a trained reference checkpoint (or ``tests/goldens/tf_reference_tiny.npz``)
drives the port with no JAX and no TF at run time. The TF names follow the
original scope structure:

* networks are wrapped in the scopes Text2Mel/{TextEnc, AudioEnc, AudioDec}
  and SSRN;
* each block is ``C_{i}`` / ``HC_{i}`` / ``D_{i}`` with one running counter
  per network; TextEnc's blocks start at 2 (its embedding took 1);
* conv1d -> ``<scope>/conv1d/{kernel,bias}``; conv2d_transpose ->
  ``<scope>/conv2d_transpose/{kernel,bias}``;
* layer norm -> ``<scope>/normalize/{beta,gamma}`` for conv blocks and
  ``<scope>/{H1,H2}/{beta,gamma}`` for HC blocks;
* the embedding -> ``Text2Mel/TextEnc/embed_1/lookup_table``.

Input: a flat ``{var_name: array}`` dict (a TF checkpoint exported to npz).
Output: trees of float32 CPU tensors matching ``Text2Mel.init`` /
``SSRN.init``. Layouts: conv kernels are TF's (K, in, out) as they are;
deconv kernels are TF's (1, K, out, in) with ours w[k] = tf[0, k].T.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from .config import Config
from .models.blocks import C, D, HC
from .models.ssrn import ssrn_specs
from .models.text2mel import audio_dec_specs, audio_enc_specs, text_enc_specs


def _t(x) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float32)


def _np(x) -> np.ndarray:
    """A torch tensor or array-like as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _deconv_from_tf(k) -> np.ndarray:
    """TF conv2d_transpose kernel (1, K, out, in) -> ours (K, in, out)."""
    return np.transpose(k[0], (0, 2, 1))


def _deconv_to_tf(w) -> np.ndarray:
    """Ours (K, in, out) -> TF conv2d_transpose kernel (1, K, out, in)."""
    return np.transpose(w, (0, 2, 1))[None]


def _stack_scopes(specs, prefix: str, start_i: int) -> List[str]:
    """The original per-network C_/HC_/D_ counter naming."""
    return [f"{prefix}/"
            f"{'D' if isinstance(s, D) else 'HC' if isinstance(s, HC) else 'C'}"
            f"_{i}" for i, s in enumerate(specs, start_i)]


def _tf_keys(scope: str, spec) -> Dict[Tuple[str, str], str]:
    """{(param group, leaf): TF name} of one block."""
    conv = "conv2d_transpose" if isinstance(spec, D) else "conv1d"
    keys = {("conv", "w"): f"{scope}/{conv}/kernel",
            ("conv", "b"): f"{scope}/{conv}/bias"}
    if isinstance(spec, HC):
        for ours, tf in (("ln1", "H1"), ("ln2", "H2")):
            keys[(ours, "beta")] = f"{scope}/{tf}/beta"
            keys[(ours, "gamma")] = f"{scope}/{tf}/gamma"
    elif isinstance(spec, (C, D)):
        keys[("ln", "beta")] = f"{scope}/normalize/beta"
        keys[("ln", "gamma")] = f"{scope}/normalize/gamma"
    else:
        raise TypeError(spec)
    return keys


def _block_param(tf_vars, scope: str, spec) -> dict:
    """One block's parameter dict from the TF variables under ``scope``."""
    p: dict = {}
    for (group, leaf), name in _tf_keys(scope, spec).items():
        v = tf_vars[name]
        if isinstance(spec, D) and (group, leaf) == ("conv", "w"):
            v = _deconv_from_tf(v)
        p.setdefault(group, {})[leaf] = _t(v)
    return p


def _networks(cfg: Config):
    """(tree path, specs, TF prefix, first counter) of every stack."""
    return (("text_enc", text_enc_specs(cfg), "Text2Mel/TextEnc", 2),
            ("audio_enc", audio_enc_specs(cfg), "Text2Mel/AudioEnc", 1),
            ("audio_dec", audio_dec_specs(cfg), "Text2Mel/AudioDec", 1),
            ("stack", ssrn_specs(cfg), "SSRN", 1))


_EMBED = "Text2Mel/TextEnc/embed_1/lookup_table"


def _convert_stack(tf_vars, specs, prefix: str, start: int) -> list:
    return [_block_param(tf_vars, s, spec)
            for s, spec in zip(_stack_scopes(specs, prefix, start), specs)]


def convert_text2mel(tf_vars: Dict[str, np.ndarray], cfg: Config) -> dict:
    """TF variables -> Text2Mel parameters."""
    params = {"embed": {"table": _t(tf_vars[_EMBED])}}
    for key, specs, prefix, start in _networks(cfg)[:3]:
        params[key] = _convert_stack(tf_vars, specs, prefix, start)
    return params


def convert_ssrn(tf_vars: Dict[str, np.ndarray], cfg: Config) -> dict:
    """TF variables -> SSRN parameters."""
    key, specs, prefix, start = _networks(cfg)[3]
    return {key: _convert_stack(tf_vars, specs, prefix, start)}


def convert(tf_vars: Dict[str, np.ndarray], cfg: Config
            ) -> Tuple[dict, dict]:
    """TF variables -> (text2mel_params, ssrn_params)."""
    return convert_text2mel(tf_vars, cfg), convert_ssrn(tf_vars, cfg)


def export_tf_names(t2m_params: dict, ssrn_params: dict, cfg: Config
                    ) -> Dict[str, np.ndarray]:
    """Parameter trees (torch tensors or arrays, e.g. gradients) -> a flat
    numpy dict under the original TF variable names. A stack given as an
    empty list exports nothing."""
    out = {_EMBED: _np(t2m_params["embed"]["table"])}
    trees = {"text_enc": t2m_params, "audio_enc": t2m_params,
             "audio_dec": t2m_params, "stack": ssrn_params}
    for key, specs, prefix, start in _networks(cfg):
        scopes = _stack_scopes(specs, prefix, start)
        for scope, spec, p in zip(scopes, specs, trees[key][key]):
            for (group, leaf), name in _tf_keys(scope, spec).items():
                v = _np(p[group][leaf])
                if isinstance(spec, D) and (group, leaf) == ("conv", "w"):
                    v = _deconv_to_tf(v)
                out[name] = v
    return out
