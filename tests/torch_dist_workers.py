"""Ranks of the port's multi-process tests (tests/test_torch_parallel.py).

    python tests/torch_dist_workers.py SUITE RANK WORLD DIR

joins a gloo process group of WORLD processes on the CPU through a file
store in DIR (no TCP port: test workers run side by side), reads the
inputs the test wrote to ``DIR/inputs.pt``, runs the suite's scenarios and
writes what each computed to ``DIR/SUITE_RANK.pt``.  Suites: ``w2`` (two
ranks: the data-parallel sampler, data-parallel training, synchronised
BatchNorm, checkpoints in both directions, the divergence check, the
training command line, the onset evaluation) and ``w4`` (four ranks on a 2x2
(data, model) mesh: FSDP and model_parallel training, checkpoints, the
training command line under FSDP) and ``gpt`` (two ranks: the CondFoleyGen
GPT's trainer in DDP and under FSDP on a 1x2 mesh).

This module imports no JAX: the ranks run the port alone.  The test process
imports it too, for the single-process runs the ranks are held against.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import torch.distributed as dist  # noqa: E402

from syncfusion_tpu_torch.core.checkpoint import CheckpointConfig, Checkpointer  # noqa: E402
from syncfusion_tpu_torch.core.config import GPTConfig, OnsetConfig  # noqa: E402
from syncfusion_tpu_torch.core.logging import MetricLogger  # noqa: E402
from syncfusion_tpu_torch.core.mesh import (  # noqa: E402
    Mesh,
    MeshSpec,
    create_mesh,
    init_distributed,
    rank_zero,
    replicate_check,
)
from syncfusion_tpu_torch.data.prefetch import to_device  # noqa: E402
from syncfusion_tpu_torch.models.mingpt import GPTFeats  # noqa: E402
from syncfusion_tpu_torch.models.onset_net import Conv3d, VideoOnsetNet  # noqa: E402
from syncfusion_tpu_torch.models.syncfusion import SyncFusionDiffusion  # noqa: E402
from syncfusion_tpu_torch.parallel.sampling import DataParallelSampler  # noqa: E402
from syncfusion_tpu_torch.train.diffusion_trainer import (  # noqa: E402
    DiffusionTrainer,
    OptimizerConfig,
)
from syncfusion_tpu_torch.models.transformer_av import AVCondTransformer  # noqa: E402
from syncfusion_tpu_torch.models.vqgan.model import VQModel  # noqa: E402
from syncfusion_tpu_torch.train.onset_trainer import OnsetTrainer, bc_loss  # noqa: E402
from syncfusion_tpu_torch.train.transformer_trainer import TransformerTrainer  # noqa: E402

CPU = torch.device("cpu")
TRAIN_STEPS = 6  # micro-steps: 3 optimizer updates at accumulation 2
SAVE_AT = 3  # mid-accumulation
FSDP_MIN_SIZE = 256  # tests/test_parallel.py's threshold for the tiny model
GPT_VQ = dict(embed_dim=16, n_embed=32, ch=8, ch_mult=(1, 2, 2), num_res_blocks=1,
              attn_resolutions=(10,), resolution=40, z_channels=16)
GPT_CFG = dict(vocab_size=32, block_size=128, n_layer=2, n_head=2, n_embd=16)
ONSET_RECIPE = dict(lr=1e-4, lr_beta1=0.9, lr_beta2=0.999, lr_eps=1e-8,
                    lr_weight_decay=1e-3, gradient_clip_val=1e9,
                    accumulate_grad_batches=1)


def tiny_model(model_cfg, dtype=torch.float64) -> SyncFusionDiffusion:
    """The tiny SyncFusion from seed 0, its parameters and compute in
    ``dtype``."""
    return SyncFusionDiffusion.from_config(model_cfg, dtype=dtype, device="cpu",
                                           seed=0).to(dtype)


def train_run(inputs, mesh: Mesh, fsdp: bool = False, restore=None,
              save_dir=None) -> dict:
    """f64 training of the tiny model over ``mesh``: ``TRAIN_STEPS``
    micro-steps on the global batches of ``inputs``, accumulation 2,
    CFG dropout 0.5; from the checkpoint directory ``restore`` when given;
    a checkpoint into ``save_dir`` after ``SAVE_AT`` micro-steps when
    given.  Returns the losses, the final full state (rank 0), and each
    parameter's (stored, whole) element counts."""
    trainer = DiffusionTrainer(
        tiny_model(inputs["model_cfg"]), OptimizerConfig(accumulate_grad_batches=2),
        embedding_mask_proba=0.5, mesh=mesh, fsdp=fsdp, fsdp_min_size=FSDP_MIN_SIZE)
    state = trainer.create_state()
    if restore is not None:
        state.load_state_dict(Checkpointer(CheckpointConfig(restore), mesh).restore())
    losses = []
    while state.step < TRAIN_STEPS:
        i = state.step
        batch = to_device(inputs["train_batches"][i], CPU, mesh)
        losses.append(trainer.train_step(state, batch, torch.Generator().manual_seed(i))
                      ["train_loss"].item())
        if save_dir is not None and state.step == SAVE_AT:
            Checkpointer(CheckpointConfig(save_dir), mesh).save(state.step, state.state_dict())
    numel = {}
    for name, p in trainer.model.named_parameters():
        local = p.to_local() if hasattr(p, "to_local") else p
        numel[name] = (local.numel(), p.numel())
    full = state.state_dict()
    return {"losses": losses, "state": full if rank_zero() else None, "numel": numel,
            "step": state.step}


@torch.no_grad()
def loss_rows(inputs, mesh: Mesh) -> float:
    """The global f32 loss of ``inputs["loss_batch"]`` (with its sigma and
    noise) through the trainer's wrapped model, each rank on its rows."""
    model = SyncFusionDiffusion.from_config(inputs["model_cfg"], device="cpu")
    model.load_state_dict(inputs["sampler_state"], strict=True)
    trainer = DiffusionTrainer(model, mesh=mesh)
    b = to_device(inputs["loss_batch"], CPU, mesh)
    loss = trainer.module(b["wav"], b["onsets"], b["embedding"], sigma=b["sigma"],
                          noise=b["noise"])
    return trainer._global_mean(loss).item()


def onset_step(inputs, mesh: Mesh) -> dict:
    """One f32 ``OnsetTrainer.train_step`` of the converted JAX onset net on
    the global batch of ``inputs``: the global loss, the gathered logits and
    the BatchNorm buffers after it."""
    net = VideoOnsetNet((1, 1, 1, 1))
    net.load_state_dict(inputs["onset_state"], strict=True)
    trainer = OnsetTrainer(net, OptimizerConfig(**ONSET_RECIPE), mesh=mesh)
    state = trainer.create_state()
    batch = to_device(inputs["onset_batch"], CPU, mesh)
    metrics, logits = trainer.train_step(state, batch)
    buffers = {k: v.clone() for k, v in net.state_dict().items()
               if k.endswith(("running_mean", "running_var"))}
    return {"loss": metrics["loss/train"].item(),
            "logits": trainer.gather_rows(logits).numpy(), "buffers": buffers,
            "pos_weight_loss": bc_loss(batch["label"] * 0 + 1.5, batch["label"],
                                       trainer.group).item()}


def onset_evaluate(inputs, mesh: Mesh) -> dict:
    """``train_onset.evaluate`` of the converted onset net over
    ``inputs["onset_items"]`` in batches of 4 (the last one ragged)."""
    from syncfusion_tpu_torch import train_onset

    net = VideoOnsetNet((1, 1, 1, 1))
    net.load_state_dict(inputs["onset_state"], strict=True)
    trainer = OnsetTrainer(net, mesh=mesh)
    cfg = OnsetConfig.from_dict({"data": {"batch_size": 4, "num_workers": 1}})
    return train_onset.evaluate(trainer, trainer.create_state(), inputs["onset_items"],
                                cfg, CPU)


def sample_rows(inputs, mesh: Mesh) -> dict:
    """Each sampler case of ``inputs``: this rank's rows and their global
    indices."""
    model = SyncFusionDiffusion.from_config(inputs["model_cfg"], device="cpu")
    model.load_state_dict(inputs["sampler_state"], strict=True)
    out = {}
    onsets, emb = inputs["sampler_onsets"], inputs["sampler_embedding"]
    for name, kw in inputs["sampler_cases"].items():
        sampler = DataParallelSampler(model.eval(), mesh, per_chip_batch=2,
                                      length=onsets.shape[1], **kw)
        gen = torch.Generator().manual_seed(inputs["sampler_seed"])
        out[name] = (sampler(onsets, emb, gen).numpy(), sampler.local_indices())
    return out


def divergent_replicas(inputs, mesh: Mesh) -> dict:
    """``replicate_check`` on equal parameters, then on parameters drawn
    from a seed per rank."""
    same = SyncFusionDiffusion.from_config(inputs["model_cfg"], device="cpu", seed=0)
    replicate_check(same.parameters(), mesh)
    other = SyncFusionDiffusion.from_config(inputs["model_cfg"], device="cpu",
                                            seed=mesh.rank)
    try:
        replicate_check(other.parameters(), mesh)
    except ValueError as e:
        return {"raised": str(e)}
    return {"raised": None}


def train_cli(args: list, logger_dir: Path) -> dict:
    """``train_diffusion.main(args)``; a ``MetricLogger`` of this rank's own
    into ``logger_dir``/rank<r>.  Returns the step and a digest of the
    parameters."""
    from syncfusion_tpu_torch import train_diffusion

    state = train_diffusion.main(args)
    logger = MetricLogger(logger_dir / f"rank{dist.get_rank()}")
    logger.log({"x": 1.0}, step=1)
    logger.close()
    whole = [p.full_tensor() if hasattr(p, "full_tensor") else p
             for p in state.model.parameters()]
    return {"step": state.step,
            "digest": sum(p.detach().double().abs().sum().item() for p in whole)}


def gpt_model() -> AVCondTransformer:
    """The tiny baseline (20 x 40 spectrograms, a 2-layer GPT of width 16,
    pkeep 0.5; the video net at full width), seeded, all in f64 (the video
    net's convolutions too)."""
    model = AVCondTransformer(VQModel(**GPT_VQ), GPTFeats(GPTConfig(**GPT_CFG)),
                              pkeep=0.5).init(0).double()
    for m in model.video.modules():
        if isinstance(m, Conv3d):
            m.dtype = torch.float64
    return model


def gpt_run(inputs, mesh: Mesh, fsdp: bool = False) -> dict:
    """``TransformerTrainer`` steps on ``inputs["gpt_batches"]`` (global
    batches; the rank takes its rows), the corruption drawn from generators
    seeded 100, 101, ...; then the val loss and the whole state (rank 0)."""
    trainer = TransformerTrainer(gpt_model(), mesh=mesh, fsdp=fsdp,
                                 fsdp_min_size=FSDP_MIN_SIZE)
    state = trainer.create_state()
    losses = []
    for i, batch in enumerate(inputs["gpt_batches"]):
        rows = mesh.rows(batch["spec"].shape[0])
        metrics = trainer.train_step(state, {k: v[rows] for k, v in batch.items()},
                                     torch.Generator().manual_seed(100 + i))
        losses.append(float(metrics["train/loss"]))
    val = trainer.eval_step(state, {k: v[rows] for k, v in batch.items()})
    sd = state.state_dict()
    return {"losses": losses, "val": float(val["val/loss"]), "fsdp": trainer.fsdp,
            "state": sd if rank_zero() else None}


def run_gpt(inputs, out_dir: Path) -> dict:
    return {"ddp": gpt_run(inputs, create_mesh()),
            "fsdp": gpt_run(inputs, create_mesh(MeshSpec(data=-1, model=2)), fsdp=True)}


def run_w2(inputs, out_dir: Path) -> dict:
    mesh = create_mesh()
    return {
        "sampler": sample_rows(inputs, mesh),
        "loss": loss_rows(inputs, mesh),
        "dp": train_run(inputs, mesh, save_dir=out_dir / "ckpt_w2"),
        "dp_restored": train_run(inputs, mesh, restore=inputs["ckpt_w1"]),
        "onset": onset_step(inputs, mesh),
        "onset_eval": onset_evaluate(inputs, mesh),
        "divergent": divergent_replicas(inputs, mesh),
        "cli": train_cli(inputs["cli_args"], out_dir / "logger_w2"),
    }


def run_w4(inputs, out_dir: Path) -> dict:
    mesh = create_mesh(MeshSpec(data=-1, model=2))
    return {
        "fsdp": train_run(inputs, mesh, fsdp=True, save_dir=out_dir / "ckpt_w4"),
        "fsdp_restored": train_run(inputs, mesh, fsdp=True, restore=inputs["ckpt_w1"]),
        "model_parallel": train_run(inputs, mesh),
        "cli": train_cli(inputs["cli_args"] + ["--logs_dir", str(out_dir / "logs_fsdp"),
                                               "--model_parallel", "2", "--fsdp", "true"],
                         out_dir / "logger_w4"),
    }


def main(suite: str, rank: int, world: int, out_dir: str) -> None:
    torch.set_num_threads(1)
    out_dir = Path(out_dir)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    init_distributed("cpu", f"file://{out_dir / f'store_{suite}'}", rank, world)
    inputs = torch.load(out_dir / "inputs.pt", weights_only=False)
    result = {"w2": run_w2, "w4": run_w4, "gpt": run_gpt}[suite](inputs, out_dir)
    torch.save(result, out_dir / f"{suite}_{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
