"""Training CLI: ``python -m dc_tts_tpu_torch.train {1,2}``.

``1`` trains Text2Mel, ``2`` SSRN: an endless loop over shuffled batches,
a checkpoint (the JAX package's npz layout) and alignment/spectrogram plots
every ``--ckpt-every`` steps, resume from the latest checkpoint on restart,
stop at ``--max-steps``. The same flags and cadence as
``python -m dc_tts_tpu.train``, plus ``--device`` (default cuda; raises
without a card unless ``--device cpu``). ``--dtype`` sets
``cfg.compute_dtype``; ``--pallas`` sets ``cfg.use_pallas``, so that every
HC block of the network trains through kernel K4 (``ops/hc_vjp.py``), in
bf16 operands under ``--dtype bfloat16``. The JAX PRNG choice is refused.

Data parallelism: under ``torchrun --nproc-per-node N`` every rank is one
process with one device (NCCL on cards, gloo with ``--device cpu``);
``--data-parallel`` ranks (default all) each take their rows of every
global batch (the loader seeded alike on every rank), the gradients are
summed over them before each update, and only rank 0 writes checkpoints,
logs and plots. Without ``torchrun`` it runs as one rank.

Tensor parallelism: ``--model-parallel m`` lays the ranks out as a
``data x m`` grid (``parallel.make_mesh``; data defaults to the ranks over
m) and each model rank holds its slice of every conv kernel's output
channels (``parallel/tp.py``), as JAX's GSPMD shards them. Every rank
draws the whole initial state from the seed (or restores the whole
checkpoint) and keeps its slices. A checkpoint holds whole arrays, the
file a one-rank run writes: every rank gathers the parameters and Adam's
moments over its model group, rank 0 writes them and draws the plots from
them.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..config import base_config, test_config
from ..data.dataset import (TrainLoader, compute_bucket_shapes,
                            load_dataset_index)
from ..device import resolve_device
from ..params import requires_grad
from ..parallel import distributed
from ..parallel.mesh import make_mesh, prefetch_to_device
from ..utils.logging import MetricLogger
from ..utils.plotting import plot_alignment, plot_spectrogram
from . import checkpoint
from .steps import (TrainState, gather_state, init_ssrn_state,
                    init_text2mel_state, make_ssrn_step, make_text2mel_step,
                    replicate_state, shard_state, teacher_forcing_shift)


def _plots(num: int, cfg, params, batch, gs: int, tag: str, logdir: str,
           logger: MetricLogger) -> None:
    """The alignment and spectrogram images of one checkpoint."""
    from ..models.ssrn import SSRN
    from ..models.text2mel import Text2Mel
    with torch.no_grad():
        if num == 1:
            S = teacher_forcing_shift(batch["mels"])
            _, Y, align, _ = Text2Mel(cfg).apply(params, batch["texts"], S)
            align, gt, hat = (t[0].cpu().numpy()
                              for t in (align, batch["mels"], Y))
            plot_alignment(align, tag, logdir)
            logger.log_image(gs, "alignment", align)
            names = ("mel_gt", "mel_hat")
        else:
            _, Z = SSRN(cfg).apply(params, batch["mels"])
            gt, hat = (t[0].cpu().numpy() for t in (batch["mags"], Z))
            names = ("mag_gt", "mag_hat")
    for name, img in zip(names, (gt, hat)):
        plot_spectrogram(img, name, tag, logdir)
        logger.log_image(gs, name, np.asarray(img).T)


def main(argv=None):
    ap = argparse.ArgumentParser(description="Train Text2Mel (1) or SSRN (2)")
    ap.add_argument("num", type=int, choices=[1, 2])
    ap.add_argument("--data", default=None, help="corpus dir (transcript.csv)")
    ap.add_argument("--features", default=".",
                    help="dir containing mels/ and mags/ from prepro")
    ap.add_argument("--on-the-fly", action="store_true",
                    help="compute spectrograms in the loader threads instead "
                         "of reading prepro's .npy features")
    ap.add_argument("--logdir", default=None)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--max-steps", type=int, default=None)
    ap.add_argument("--ckpt-every", type=int, default=1000)
    ap.add_argument("--keep-ckpts", type=int, default=5,
                    help="checkpoints retained; 0 keeps all")
    ap.add_argument("--log-every", type=int, default=50)
    ap.add_argument("--data-parallel", type=int, default=None,
                    help="data-parallel ranks (default: all the ranks "
                         "torchrun starts, else 1)")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="model-parallel ranks: each holds a slice of every "
                         "conv kernel's output channels")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tiny", action="store_true",
                    help="use the tiny test config")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16", "bfloat16_full"],
                    help="conv matmul operand dtype. bfloat16 rounds the "
                         "operands to bf16 with float32 accumulation. "
                         "bfloat16_full also stores activations (conv "
                         "outputs, LN/gate chains, residuals) in bf16; LN "
                         "statistics still compute in float32")
    ap.add_argument("--pallas", action="store_true",
                    help="train every HC block through kernel K4, its "
                         "forward and hand-written backward (float32 or, "
                         "with --dtype bfloat16, bf16 operands; K4 takes "
                         "float32 activations, so under bfloat16_full the "
                         "HC blocks keep the eager path)")
    ap.add_argument("--rng", default=None,
                    help="not ported: selects a JAX PRNG implementation; "
                         "the port draws dropout masks from torch.Generator")
    ap.add_argument("--tensorboard", action="store_true",
                    help="also write TensorBoard event files into the logdir")
    ap.add_argument("--buckets", type=int, default=3,
                    help="number of static length-bucket shapes; 1 trains "
                         "on the full grid only")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where to run (default cuda; no CPU fallback)")
    args = ap.parse_args(argv)
    if args.rng is not None:
        ap.error("--rng selects a JAX PRNG implementation and is not ported "
                 "to the PyTorch package")
    device = resolve_device(args.device)
    distributed.initialize(device=device)
    n_ranks = distributed.world()[1]
    data, model = args.data_parallel or 1, args.model_parallel
    if model < 1 or data * model > n_ranks:
        ap.error(f"--data-parallel {data} x --model-parallel {model} needs "
                 f"{data * model} ranks; this run has {n_ranks} (start it "
                 f"under torchrun --nproc-per-node {data * model})")
    mesh = make_mesh(data=args.data_parallel, model=model)
    if mesh.coords is None:
        return          # a rank the grid leaves out
    rank0 = distributed.world()[0] == 0
    group, model_group = mesh.groups["data"], mesh.groups["model"]

    cfg = test_config() if args.tiny else base_config()
    if args.dtype != "float32":
        cfg = cfg.replace(compute_dtype=args.dtype)
    if args.pallas:
        cfg = cfg.replace(use_pallas=True)
    if args.data:
        cfg = cfg.replace(data=args.data)
    if args.batch_size:
        cfg = cfg.replace(B=args.batch_size)
    if cfg.B % mesh.shape["data"]:
        ap.error(f"batch size {cfg.B} does not divide over "
                 f"{mesh.shape['data']} data-parallel ranks")
    logdir = args.logdir or (cfg.logdir + "-" + str(args.num))
    max_steps = args.max_steps or cfg.num_iterations
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    log = print if rank0 else (lambda *a, **k: None)
    log(f"device: {device} ({name})  mesh: {mesh.shape}")

    examples = load_dataset_index(cfg, args.features, cfg.data,
                                  on_the_fly=args.on_the_fly)
    log(f"dataset: {len(examples)} usable examples"
        + (" (on-the-fly features)" if args.on_the_fly else ""))
    buckets = None
    if args.buckets > 1:
        buckets = compute_bucket_shapes(cfg, examples, args.features,
                                        args.buckets,
                                        on_the_fly=args.on_the_fly)
        log(f"buckets: {buckets}")
    loader = TrainLoader(cfg, examples, args.features, seed=args.seed,
                         buckets=buckets, on_the_fly=args.on_the_fly)

    gen = torch.Generator().manual_seed(args.seed)
    if args.num == 1:
        state = init_text2mel_state(cfg, gen, device)
        step_fn = make_text2mel_step(cfg, seed=args.seed + 1, group=group,
                                     model_group=model_group)
    else:
        state = init_ssrn_state(cfg, gen, device)
        step_fn = make_ssrn_step(cfg, seed=args.seed + 1, group=group,
                                 model_group=model_group)

    # full-state resume: parameters, Adam moments and schedule counts; a
    # params-only checkpoint restores with fast-forwarded counts. The whole
    # arrays, then this rank's slices of them.
    params, opt_state, start_step, kind = checkpoint.restore_train_state(
        logdir, state.params, state.opt_state)
    requires_grad(params)
    state = shard_state(TrainState(params, opt_state, start_step), mesh)
    replicate_state(state, mesh)
    if start_step:
        log(f"resumed from step {start_step} ({kind} checkpoint)")

    logger = MetricLogger(logdir, tensorboard=args.tensorboard) \
        if rank0 else None
    drop_gen = torch.Generator(device=device)
    t_last, n_last = time.time(), start_step
    gs = start_step
    for batch in prefetch_to_device(loader, device, mesh):
        if gs >= max_steps:
            break
        state, metrics = step_fn(state, batch, drop_gen)
        gs = state.step
        if gs % args.log_every == 0 and rank0:
            loss = float(metrics["loss"])
            now = time.time()
            sps = (gs - n_last) / max(now - t_last, 1e-9)
            t_last, n_last = now, gs
            logger.log(gs, {**{k: float(v) for k, v in metrics.items()},
                            "steps_per_sec": sps})
            print(f"step {gs}  loss {loss:.4f}  {sps:.2f} steps/s")
        if gs % args.ckpt_every == 0:
            params, opt_state = gather_state(state, mesh)   # collective
            if rank0:
                checkpoint.save_train_state(logdir, params, opt_state, gs,
                                            keep=args.keep_ckpts)
                _plots(args.num, cfg, params, batch, gs,
                       checkpoint.step_name(gs)[9:], logdir, logger)
    loader.stop()
    params, opt_state = gather_state(state, mesh)
    if rank0:
        checkpoint.save_train_state(logdir, params, opt_state, state.step,
                                    keep=args.keep_ckpts)
        logger.close()
    log("Done")


if __name__ == "__main__":
    main()
