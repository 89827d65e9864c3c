"""Training steps of Text2Mel and SSRN, the port of
``dc_tts_tpu/train/steps.py``.

Each network trains on its own with its own parameters and optimizer state.
A step is ``(state, batch, gen) -> (state, metrics)``: the forward with
dropout drawn from ``gen`` (reseeded from the seed and the step, the role of
``jax.random.fold_in``), the loss, the gradients by autograd (through K4's
hand-written backward under ``cfg.use_pallas``), and one optimizer update.
The update runs in place on the state's tensors, as the JAX step donates
its state. ``metrics`` are 0-d tensors on the device; nothing waits for the
device inside a step.

Spans (``utils/profiling``): ``train.step`` around a step, the root of its
tree with the step's number as the tree's id; in it ``train.forward`` (the
network, the loss and the metrics), ``train.backward`` (the gradients) and
``train.optimizer`` (clipping, Adam, Noam). A data-parallel step's
gradient sum lies between the last two, in ``train.step``'s self time.

Data parallelism (``group``, the data axis' process group): each rank's
batch holds its rows of the global batch; the losses give this rank's
share of the global batch's loss (``losses.py``), and the gradients and the
metrics are summed over the group before the update, so every rank applies
the update of the global batch. Each rank draws its own dropout masks; rank
0 draws those of a single process.

Tensor parallelism (``model_group``, the model axis' process group): the
state holds this rank's slices (``shard_state`` of a whole state that
every rank drew from the same seed), the networks gather every sharded
conv's output (``parallel/tp.py``), and every model rank computes the same
loss, with the dropout masks of its data row (the seed takes the data
coordinate, not the model one). The gradients are summed over the data
group only; the metrics are not summed over the model group.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import Config
from ..models.ssrn import SSRN
from ..models.text2mel import Text2Mel
from ..params import requires_grad
from ..parallel.distributed import all_reduce_sum_, broadcast_
from ..parallel.tp import gather_params, shard_params
from ..utils.profiling import span
from .losses import attention_diagonality, ssrn_loss, text2mel_loss
from .optimizer import apply_updates, init_opt_state, tree_leaves


class TrainState(NamedTuple):
    params: dict
    opt_state: list
    step: int  # global step, on the host


def _init_state(params) -> TrainState:
    requires_grad(params)
    return TrainState(params, init_opt_state(params), 0)


def init_text2mel_state(cfg: Config, gen: torch.Generator,
                        device="cpu") -> TrainState:
    return _init_state(Text2Mel(cfg).init(gen, device))


def init_ssrn_state(cfg: Config, gen: torch.Generator,
                    device="cpu") -> TrainState:
    return _init_state(SSRN(cfg).init(gen, device))


def teacher_forcing_shift(mels: torch.Tensor) -> torch.Tensor:
    """S = [0; mels[:, :-1]], the decoder's input."""
    return torch.cat([torch.zeros_like(mels[:, :1]), mels[:, :-1]], dim=1)


def step_seed(seed: int, step: int, shard: int = 0) -> int:
    """The dropout seed of one step: a function of the run's seed, the
    step and the data-parallel rank ``shard`` alone, so a resumed run draws
    the masks it would have drawn (rank 0's are a single process's)."""
    key = [seed, step] + ([shard] if shard else [])
    return int(np.random.SeedSequence(key).generate_state(1)[0])


def text2mel_grads(cfg: Config, params, batch: dict, gen=None, group=None,
                   model_group=None):
    """(metrics, gradients as a leaf list) of the Text2Mel loss (of this
    rank's share of it under a data-parallel ``group``; of this rank's
    slices under ``model_group``)."""
    with span("train.forward"):
        mels = batch["mels"]
        S = teacher_forcing_shift(mels)
        logits, Y, align, _ = Text2Mel(cfg, model_group).apply(
            params, batch["texts"], S, gen=gen, train=True)
        loss, metrics = text2mel_loss(logits, Y, align, mels, cfg,
                                      batch.get("text_lens"),
                                      batch.get("mel_lens"), group)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["attention_diagonality"] = attention_diagonality(
            align.detach(), batch.get("text_lens"), batch.get("mel_lens"),
            group)
    with span("train.backward"):
        grads = torch.autograd.grad(loss, tree_leaves(params))
    return metrics, list(grads)


def ssrn_grads(cfg: Config, params, batch: dict, gen=None, group=None,
               model_group=None):
    """(metrics, gradients as a leaf list) of the SSRN loss (share)."""
    with span("train.forward"):
        logits, Z = SSRN(cfg, model_group).apply(params, batch["mels"],
                                                 gen=gen, train=True)
        loss, metrics = ssrn_loss(logits, Z, batch["mags"], cfg, group)
    with span("train.backward"):
        grads = torch.autograd.grad(loss, tree_leaves(params))
    return {k: v.detach() for k, v in metrics.items()}, list(grads)


def _make_step(cfg: Config, grads_fn, seed: int, group, model_group):
    # the data coordinate: the data group of each model column holds one
    # rank of every data row, in row order
    shard = 0 if group is None else torch.distributed.get_rank(group)

    def step(state: TrainState, batch: dict,
             gen: Optional[torch.Generator] = None):
        with span("train.step", key=state.step):
            if gen is not None:
                gen.manual_seed(step_seed(seed, state.step, shard))
            metrics, grads = grads_fn(cfg, state.params, batch, gen, group,
                                      model_group)
            if group is not None:
                # the global batch's gradient and metrics: the shares summed
                all_reduce_sum_(grads, group)
                all_reduce_sum_(list(metrics.values()), group)
            with span("train.optimizer"):
                opt_state = apply_updates(state.params, grads,
                                          state.opt_state, cfg)
            return TrainState(state.params, opt_state, state.step + 1), \
                metrics

    return step


def make_text2mel_step(cfg: Config, seed: int = 0, group=None,
                       model_group=None):
    """The Text2Mel step. batch: texts (B, N) int, mels (B, T, n_mels),
    and optionally text_lens, mel_lens (B,); under a data-parallel
    ``group`` this rank's rows of the global batch; under ``model_group``
    the state holds this rank's slices (``shard_state``)."""
    return _make_step(cfg, text2mel_grads, seed, group, model_group)


def make_ssrn_step(cfg: Config, seed: int = 0, group=None, model_group=None):
    """The SSRN step. batch: mels (B, T/r, n_mels), mags (B, T, n_freq);
    SSRN trains on the ground-truth coarse mels."""
    return _make_step(cfg, ssrn_grads, seed, group, model_group)


def shard_state(state: TrainState, mesh) -> TrainState:
    """This rank's slices of a whole train state over the mesh's model
    axis: the parameters (marked for gradients) and Adam's moments by
    ``param_partition_specs``; the state itself on a model axis of 1."""
    if mesh.shape["model"] == 1:
        return state
    params = shard_params(state.params, mesh)
    requires_grad(params)
    return TrainState(params, shard_params(state.opt_state, mesh), state.step)


def gather_state(state: TrainState, mesh):
    """(parameters, optimizer state), whole, from this rank's slices: a
    collective over the model group, which every rank of it calls."""
    return (gather_params(state.params, mesh),
            gather_params(state.opt_state, mesh))


def replicate_state(state: TrainState, mesh) -> None:
    """Every rank of the mesh's data axis takes its rank 0's parameters
    and optimizer moments (after init or a restore), in place; under
    tensor parallelism each model column its own slices."""
    adam = state.opt_state[1]
    tensors = [t for tree in (state.params, adam["mu"], adam["nu"])
               for t in tree_leaves(tree)]
    broadcast_(tensors, mesh.ranks["data"][0], mesh.groups["data"])
