"""The port's onset model against the JAX package, on the CPU: the net
(eval and train mode, BatchNorm buffers, bf16), the trainer's steps, the
loss and metrics, the wire decodes, the colour jitter and the weight
loaders.  Tiny config: ``layers=(1, 1, 1, 1)``, frames (2, 4, 16, 16, 3).
Inputs come from numpy seeds; weights go from the JAX init to the port
through ``convert.onset_state_dict``.

Tolerances: 1e-5 relative (to the largest magnitude of each tensor) in
f32, where the two sides sum in other orders; bf16 as stated there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from syncfusion_tpu.models.onset_net import VideoOnsetNet as JaxOnsetNet
from syncfusion_tpu.ops import augment as jaug
from syncfusion_tpu.train import onset_trainer as jtr
from syncfusion_tpu.train.diffusion_trainer import OptimizerConfig as JaxOptimizerConfig
from syncfusion_tpu_torch.convert import flatten, onset_state_dict
from syncfusion_tpu_torch.models import onset_net as ton
from syncfusion_tpu_torch.ops import augment as taug
from syncfusion_tpu_torch.train import onset_trainer as ttr
from syncfusion_tpu_torch.train.diffusion_trainer import OptimizerConfig
from torch_port_helpers import n, t

LAYERS = (1, 1, 1, 1)
SHAPE = (2, 4, 16, 16, 3)
TOL = 1e-5
# The train-mode logits of the tiny net normalise its last stage's 8 values
# a channel (2 chunks x 4 frames x 1 x 1): ill-conditioned in f32.  On the
# batch of test_train_step_matches_jax_f32 the JAX package's own logits lie
# 2.3e-5 (relative) from an f64 evaluation of the same net and the port's
# 2.1e-5; the two differ by 4.2e-5.  The loss and the buffers hold at TOL,
# and the f64 test holds the logits at 1e-9.
LOGIT_TOL = 1e-4
RECIPE = dict(lr=1e-4, lr_beta1=0.9, lr_beta2=0.999, lr_eps=1e-8,
              lr_weight_decay=1e-3, gradient_clip_val=1e9, accumulate_grad_batches=1)


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def frames(seed=0, shape=SHAPE):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.fixture(scope="module")
def jax_net():
    """(JAX net, its variables)."""
    net = JaxOnsetNet(layers=LAYERS)
    variables = jax.jit(lambda: net.init(jax.random.key(3), jnp.zeros(SHAPE),
                                         train=False))()
    return net, jax.tree_util.tree_map(np.asarray, variables)


def port_net(variables, dtype=torch.float32):
    net = ton.VideoOnsetNet(LAYERS, dtype=dtype)
    net.load_state_dict(onset_state_dict(variables), strict=True)
    return net


def compare_stats(net, stats):
    """Every BatchNorm buffer of ``net`` against the JAX batch_stats."""
    sd = net.state_dict()
    flat = flatten(stats)
    assert len(flat) == sum(k.endswith(("running_mean", "running_var")) for k in sd)
    for path, want in flat.items():
        key = ".".join(path[:-1]) + {"mean": ".running_mean", "var": ".running_var"}[path[-1]]
        assert rel(n(sd[key]), want) <= TOL, key


def test_midplanes_are_the_reference_widths():
    assert [ton.midplanes(a, b) for a, b in
            ((64, 128), (128, 256), (256, 512), (64, 64), (128, 128))] == [
        230, 460, 921, 144, 288]


def test_full_width_net_has_the_reference_parameter_count():
    net = ton.VideoOnsetNet()
    assert net.param_count() == 31_365_918
    jnet = JaxOnsetNet()
    shapes = jax.eval_shape(lambda: jnet.init(jax.random.key(0),
                                              jnp.zeros((1, 2, 16, 16, 3))))
    assert net.param_count() == sum(np.prod(x.shape) for x in
                                    jax.tree_util.tree_leaves(shapes["params"]))


def test_eval_forward_matches_jax(jax_net):
    jnet, variables = jax_net
    x = frames(1)
    want = jnet.apply(variables, x, train=False)
    got = port_net(variables).eval()(t(x))
    assert got.shape == (2, 4)
    assert rel(n(got), want) <= TOL


def test_train_forward_and_bn_buffers_match_jax(jax_net):
    """Train mode: the logits from the batch statistics, and every running
    buffer after the update (Flax moves running_var by the biased batch
    variance)."""
    jnet, variables = jax_net
    x = frames(2)
    want, mutated = jnet.apply(variables, x, train=True, mutable=["batch_stats"])
    net = port_net(variables).train()
    got = net(t(x))
    assert rel(n(got), want) <= TOL
    compare_stats(net, jax.tree_util.tree_map(np.asarray, mutated["batch_stats"]))


def test_stock_batchnorm3d_would_fail_the_buffer_test(jax_net):
    """The same net with every BatchNorm swapped for a stock
    torch.nn.BatchNorm3d (same parameters and buffers, momentum 0.1):
    its forward normalises alike, but it moves running_var by the unbiased
    variance, and its buffers miss Flax's by far more than the tolerance
    (n/(n-1) = 8/7 at the last stage, where n = 2·4·1·1)."""
    jnet, variables = jax_net
    x = frames(2)
    _, mutated = jnet.apply(variables, x, train=True, mutable=["batch_stats"])
    net = port_net(variables)
    for name, mod in list(net.named_modules()):
        if isinstance(mod, ton.BatchNorm):
            stock = torch.nn.BatchNorm3d(mod.weight.shape[0], eps=ton.BN_EPS,
                                         momentum=1 - ton.BN_MOMENTUM)
            stock.load_state_dict(mod.state_dict(), strict=False)
            parent, leaf = name.rsplit(".", 1)
            setattr(net.get_submodule(parent), leaf, stock)
    with torch.no_grad():
        net.train()(t(x))
    sd = net.state_dict()
    worst = max(rel(n(sd[".".join(path[:-1]) + ".running_var"]), want)
                for path, want in flatten(mutated["batch_stats"]).items()
                if path[-1] == "var")
    assert worst > 100 * TOL


def test_bf16_forward_matches_jax(jax_net):
    """bf16 convolutions over f32 parameters on both sides; BatchNorm and
    the head in f32.  The two round the convolutions' products and sums to
    bf16 at other places (one bf16 ulp, 2^-8 relative, per layer through
    ~10 layers): 5e-2 of max |logit|."""
    jnet, variables = jax_net
    x = frames(4)
    want = JaxOnsetNet(layers=LAYERS, dtype=jnp.bfloat16).apply(variables, x, train=False)
    got = port_net(variables, torch.bfloat16).eval()(t(x))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    assert rel(n(got), want) <= 5e-2
    # f32 and bf16 differ by far less than the logits themselves
    assert rel(n(got), jnet.apply(variables, x, train=False)) <= 5e-2


def jax_state(jt, variables):
    return jtr.OnsetTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                               batch_stats=variables["batch_stats"],
                               opt_state=jt.tx.init(variables["params"]))


def uint8_batch(rng):
    return {"frames": rng.integers(0, 256, SHAPE, dtype=np.uint8),
            "label": (rng.random(SHAPE[:2]) < 0.3).astype(np.float32)}


def test_train_step_matches_jax_f32(jax_net):
    """One OnsetTrainer.train_step against the JAX _train_step in f32,
    jitter off, uint8 wire: the loss, the train-mode logits and every
    BatchNorm buffer after the step.  (The parameters after the step are
    held in f64 below: Adam's first step moves each element by about ±lr
    whatever its gradient's size, so an element whose gradient lies within
    f32 rounding of 0 moves either way; the tiny net has such elements, e.g.
    the taps of its last stage's stride-2 convs that only see padding.)"""
    jnet, variables = jax_net
    jt = jtr.OnsetTrainer(model=jnet, opt_cfg=JaxOptimizerConfig(**RECIPE))
    trainer = ttr.OnsetTrainer(port_net(variables), OptimizerConfig(**RECIPE))
    tstate = trainer.create_state()
    batch = uint8_batch(np.random.default_rng(5))
    state, metrics, logits = jax.jit(jt._train_step)(jax_state(jt, variables), batch,
                                                     np.uint32(0))
    tmetrics, tlogits = trainer.train_step(tstate, {k: t(v) for k, v in batch.items()})
    assert tstate.step == 1
    assert rel(n(tlogits), logits) <= LOGIT_TOL
    loss = float(metrics["loss/train"])
    assert abs(float(tmetrics["loss/train"]) - loss) <= TOL * abs(loss)
    compare_stats(trainer.model, jax.tree_util.tree_map(np.asarray, state.batch_stats))


def test_two_train_steps_match_jax_f64(jax_net):
    """Two OnsetTrainer.train_steps against the JAX _train_step with both
    sides in f64 (the JAX side under enable_x64, its net with dtype f64 on
    the same parameters), jitter off, on frames normalised on the host (the
    float wire, which both pass through: the uint8 decode rounds in f32,
    where XLA's fusion may round otherwise): losses, logits, every parameter
    and every buffer after each step.  This holds the trainer's semantics
    (BatchNorm's batch statistics and biased running variance, the loss,
    AdamW with its decoupled weight decay) free of f32 rounding."""
    _, variables = jax_net
    tol = 1e-9
    with jax.enable_x64(True):
        f64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)
        jt = jtr.OnsetTrainer(model=JaxOnsetNet(layers=LAYERS, dtype=jnp.float64),
                              opt_cfg=JaxOptimizerConfig(**RECIPE))
        state = jax_state(jt, f64)
        net = port_net(variables, torch.float64).double()
        trainer = ttr.OnsetTrainer(net, OptimizerConfig(**RECIPE))
        tstate = trainer.create_state()
        rng = np.random.default_rng(5)
        step = jax.jit(jt._train_step)
        for _ in range(2):
            batch = {"frames": rng.standard_normal(SHAPE),
                     "label": (rng.random(SHAPE[:2]) < 0.3).astype(np.float32)}
            state, metrics, logits = step(state, batch, np.uint32(0))
            tmetrics, tlogits = trainer.train_step(
                tstate, {k: t(v) for k, v in batch.items()})
            assert tlogits.dtype == torch.float64 and logits.dtype == jnp.float64
            assert rel(n(tlogits), logits) <= tol
            loss = float(metrics["loss/train"])
            assert abs(float(tmetrics["loss/train"]) - loss) <= tol * abs(loss)
            want = onset_state_dict({
                "params": jax.tree_util.tree_map(np.asarray, state.params),
                "batch_stats": jax.tree_util.tree_map(np.asarray, state.batch_stats)})
            sd = net.state_dict()
            assert sd.keys() == want.keys()
            for key, w in want.items():
                # onset_state_dict rounds to f32: compare at f32's resolution
                assert rel(n(sd[key]).astype(np.float32), n(w)) <= 1e-6, key
    assert tstate.step == 2
    start = onset_state_dict(variables)
    assert all(not torch.equal(sd[k].float(), start[k]) for k in sd
               if not k.endswith(("running_mean", "running_var")))


def test_eval_forward_of_the_trainer_matches_jax(jax_net):
    jnet, variables = jax_net
    jt = jtr.OnsetTrainer(model=jnet)
    state = jtr.OnsetTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                                batch_stats=variables["batch_stats"], opt_state=None)
    wire = np.random.default_rng(6).integers(0, 256, SHAPE, dtype=np.uint8)
    want = jt._forward(state, jnp.asarray(wire))
    trainer = ttr.OnsetTrainer(port_net(variables))
    got = trainer.forward(trainer.create_state(), t(wire))
    assert rel(n(got), want) <= TOL


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bc_loss_matches_jax(seed):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(4, 30)).astype(np.float32) * 3
    targets = (rng.random((4, 30)) < 0.1 * seed).astype(np.float32)  # seed 0: none
    want = float(jtr.bc_loss(jnp.asarray(logits), jnp.asarray(targets)))
    got = float(ttr.bc_loss(t(logits), t(targets)))
    assert abs(got - want) <= TOL * abs(want)


def test_collapse_consecutive_matches_jax():
    pred = (np.random.default_rng(0).random((8, 30)) < 0.5).astype(int)
    np.testing.assert_array_equal(ttr._collapse_consecutive(pred),
                                  jtr._collapse_consecutive(pred))
    np.testing.assert_array_equal(ttr._collapse_consecutive(np.array([[1, 1, 1, 0, 1, 1]])),
                                  [[1, 0, 1, 0, 1, 0]])


@pytest.mark.parametrize("case", ["random", "ties", "perfect", "count_mismatch"])
def test_onset_metrics_match_jax(case):
    """AP, Acc and OnsNumAcc against the JAX metrics, whose AP is
    scikit-learn's; "ties" quantises the logits so that many scores tie."""
    rng = np.random.default_rng(7)
    targets = (rng.random((6, 30)) < 0.15).astype(np.float32)
    logits = rng.normal(size=(6, 30)).astype(np.float32) + 2 * targets
    if case == "ties":
        logits = np.round(logits)
    elif case == "perfect":
        logits = np.where(targets > 0, 10.0, -10.0).astype(np.float32)
    elif case == "count_mismatch":
        targets = np.zeros((1, 10), np.float32)
        targets[0, 2] = 1.0
        logits = np.full((1, 10), -10.0, np.float32)
        logits[0, [2, 7]] = 10.0
    got, want = ttr.onset_metrics(logits, targets), jtr.onset_metrics(logits, targets)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12, abs=1e-12), k


@pytest.mark.parametrize("seed", range(6))
def test_numpy_average_precision_matches_sklearn(seed):
    from sklearn.metrics import average_precision_score

    rng = np.random.default_rng(seed)
    size = int(rng.integers(2, 200))
    target = (rng.random(size) < rng.uniform(0.05, 0.9)).astype(np.float64)
    target[0] = 1.0
    score = rng.random(size)
    if seed % 2:
        score = np.round(score * 4) / 4  # heavy ties
    assert ttr.average_precision(target, score) == pytest.approx(
        average_precision_score(target, score), rel=1e-12)


def test_uint8_wire_decode_matches_jax():
    wire = np.random.default_rng(8).integers(0, 256, (2, 3, 6, 6, 3), dtype=np.uint8)
    want = jtr.OnsetTrainer._prep_frames(jnp.asarray(wire))
    got = ttr.OnsetTrainer.prep_frames(t(wire))
    assert rel(n(got), want) <= TOL
    normed = np.random.default_rng(9).standard_normal((1, 2, 4, 4, 3)).astype(np.float32)
    assert torch.equal(ttr.OnsetTrainer.prep_frames(t(normed)), t(normed))


def test_yuv420_wire_decode_matches_jax():
    from syncfusion_tpu_torch.data.transforms import FrameTransform

    rng = np.random.default_rng(10)
    wire = np.stack([FrameTransform(size=8, wire_yuv420=True)(f)
                     for f in rng.random((2, 3, 8, 8, 3)).astype(np.float32)])
    assert wire.shape == (2, 3, 12, 8)
    want = jtr.OnsetTrainer._prep_frames(jnp.asarray(wire))
    got = ttr.OnsetTrainer.prep_frames(t(wire))
    assert got.shape == (2, 3, 8, 8, 3)
    assert rel(n(got), want) <= TOL


ADJUSTERS = [("brightness", 1.3), ("contrast", 0.85), ("saturation", 1.35),
             ("hue", 0.07), ("hue", -0.09)]


@pytest.mark.parametrize("name,f", ADJUSTERS)
def test_jitter_adjusters_match_jax(name, f):
    x = np.random.default_rng(11).random((3, 5, 6, 3)).astype(np.float32)
    want = getattr(jaug, f"_jadjust_{name}")(jnp.asarray(x), f)
    got = getattr(taug, f"adjust_{name}")(t(x), f)
    assert np.abs(n(got) - np.asarray(want)).max() <= 1e-6


def test_color_jitter_on_drawn_factors_and_orders_matches_jax():
    """apply_color_jitter with per-sample factors and op orders against the
    JAX adjusters applied sample by sample in the same orders."""
    x = np.random.default_rng(12).random((4, 3, 6, 6, 3)).astype(np.float32)
    gen = torch.Generator().manual_seed(0)
    fb, fc, fs, fh, perms = taug.draw_jitter(4, gen, 0.4, 0.2, 0.4, 0.1)
    assert sorted(perms[0].tolist()) == [0, 1, 2, 3]
    got = n(taug.apply_color_jitter(t(x), fb, fc, fs, fh, perms))
    ops = [jaug._jadjust_brightness, jaug._jadjust_contrast,
           jaug._jadjust_saturation, jaug._jadjust_hue]
    for i in range(4):
        y = jnp.asarray(x[i])
        factors = [float(fb[i]), float(fc[i]), float(fs[i]), float(fh[i])]
        for op in perms[i].tolist():
            y = ops[op](y, factors[op])
        assert np.abs(got[i] - np.asarray(y)).max() <= 1e-6
    again = taug.color_jitter_device(t(x), torch.Generator().manual_seed(0))
    assert np.array_equal(n(again), got)


def test_torchvision_state_dict_loader():
    """A torchvision-layout state dict (bare and with the reference's
    prefix, with and without the fc head) loads into the port's net; its
    backbone forward is the original's."""
    src = ton.VideoOnsetNet().init(1).eval()
    sd = {}
    for key, val in src.state_dict().items():
        parts = key.split(".")
        if parts[0] != "backbone":
            sd[{"fc1": "fc.0", "fc2": "fc.2"}[parts[0]] + "." + parts[-1]] = val
            continue
        mod, rest = parts[1], ".".join(parts[2:])
        if mod.startswith("stem"):
            sd[{"stem_spatial": "stem.0", "stem_bn1": "stem.1", "stem_temporal": "stem.3",
                "stem_bn2": "stem.4"}[mod] + "." + rest] = val
            continue
        stage, b = mod[len("layer"):].split("_")
        sub, leaf = ".".join(parts[2:-1]), parts[-1]
        tv = {"conv1.spatial": "conv1.0.0", "conv1.bn": "conv1.0.1",
              "conv1.temporal": "conv1.0.3", "bn1": "conv1.1",
              "conv2.spatial": "conv2.0.0", "conv2.bn": "conv2.0.1",
              "conv2.temporal": "conv2.0.3", "bn2": "conv2.1",
              "downsample_conv": "downsample.0", "downsample_bn": "downsample.1"}[sub]
        sd[f"layer{stage}.{b}.{tv}.{leaf}"] = val
        if leaf == "running_var":
            sd[f"layer{stage}.{b}.{tv}.num_batches_tracked"] = torch.tensor(3)
    x = torch.from_numpy(frames(13, (1, 2, 16, 16, 3)))
    want = src(x)
    full = ton.VideoOnsetNet()
    full.load_state_dict(ton.convert_torch_r2plus1d(
        {f"model.net.model.{k}": v for k, v in sd.items()}), strict=True)
    assert torch.equal(full.eval()(x), want)
    backbone_only = {k: v for k, v in sd.items() if not k.startswith("fc")}
    net = ton.VideoOnsetNet()
    missing, unexpected = net.load_state_dict(ton.convert_torch_r2plus1d(backbone_only),
                                              strict=False)
    assert not unexpected and sorted(missing) == ["fc1.bias", "fc1.weight", "fc2.bias",
                                                  "fc2.weight"]
    feats = net.eval().backbone(x.permute(0, 4, 1, 2, 3))
    assert torch.equal(feats, src.backbone(x.permute(0, 4, 1, 2, 3)))


def test_seeded_init_follows_flax_distributions():
    a, b, c = (ton.VideoOnsetNet(LAYERS).init(s).state_dict() for s in (0, 0, 1))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["fc1.weight"], c["fc1.weight"])
    w = a["backbone.layer1_0.conv1.spatial.weight"]
    std = (1.0 / w[0].numel()) ** 0.5
    assert w.abs().max() <= 2 * std / 0.87962566103423978 + 1e-6
    assert w.std().item() == pytest.approx(std, rel=0.05)
    assert torch.equal(a["backbone.stem_bn1.running_var"], torch.ones(45))


@pytest.mark.parametrize("wire", ["uint8", "yuv420"])
def test_device_jitter_train_step(wire):
    """The augment recipe's ColorJitter in the train step, on the quantised
    wires: the same generator seed gives the same loss, another seed
    another; f32 frames (normalised on the host) raise."""
    from syncfusion_tpu_torch.data.transforms import FrameTransform

    rng = np.random.default_rng(0)
    pixels = rng.random((2, 2, 16, 16, 3)).astype(np.float32)
    tf = FrameTransform(size=16, wire_uint8=True, wire_yuv420=wire == "yuv420")
    batch = {"frames": t(np.stack([tf(f) for f in pixels])),
             "label": t((rng.random((2, 2)) > 0.5).astype(np.float32))}

    def loss(seed):
        trainer = ttr.OnsetTrainer(ton.VideoOnsetNet(LAYERS).init(0),
                                   jitter=(0.4, 0.2, 0.4, 0.1))
        metrics, _ = trainer.train_step(trainer.create_state(), batch,
                                        torch.Generator().manual_seed(seed))
        return float(metrics["loss/train"])

    assert np.isfinite(loss(7)) and loss(7) == loss(7) != loss(8)
    trainer = ttr.OnsetTrainer(ton.VideoOnsetNet(LAYERS), jitter=(0.4, 0.2, 0.4, 0.1))
    with pytest.raises(ValueError, match="uint8 or yuv420"):
        trainer.train_frames(t(pixels))


class _InputTape(ton.ReluTape):
    """A ReluTape that also keeps |input| of each ReLU."""

    def __init__(self, replay=None):
        super().__init__(replay)
        self.inputs = []

    def relu(self, x):
        self.inputs.append(x.detach().abs())
        return super().relu(x)


def test_onset_gradients_hold_on_shared_relu_masks():
    """Why chip_smoke.py phase 12 gates the onset net's f32 gradients on
    shared ReLU masks, and the masks apart (ONSET_FLIP_TOL): the full-width
    net on 2 chunks of 8 frames at 32x32, f32 against f64 on the same
    weights and uint8 frames, gradients per tensor relative to max(max |g|,
    1e-3 of the largest) (its TRAIN_GRAD_TOL and GRAD_FLOOR).
    - f32 on the f64 run's ReLU masks agrees within 1e-3;
    - f32 on its own masks changes the sign of at most 1e-5 of the ReLU
      inputs (the gate's share);
    - one such change, the ReLU input nearest 0 taking the other side in
      the f64 run, moves the f64 gradients by more than 1e-3: the gradients
      are ill-conditioned in the masks, and rounding alone may fail a gate
      on unshared masks."""
    grad_tol, flip_tol = 1e-3, 1e-5
    shape = (2, 8, 32, 32, 3)
    rng = np.random.default_rng(3)
    frames = ttr.OnsetTrainer.prep_frames(t(rng.integers(0, 256, shape, dtype=np.uint8)))
    label = np.zeros(shape[:2], np.float32)
    label[np.arange(shape[0])[:, None], rng.integers(0, shape[1], (shape[0], 2))] = 1.0
    label = t(label)
    net32 = ton.VideoOnsetNet().init(0)
    net64 = ton.VideoOnsetNet(dtype=torch.float64).double()
    net64.load_state_dict(net32.state_dict())
    start = {k: v.clone() for k, v in net64.named_buffers()}

    def grads(net, tape):
        with tape:
            net.train().zero_grad()
            ttr.bc_loss(net(frames.to(net.fc1.weight.dtype)),
                        label.to(net.fc1.weight.dtype)).backward()
        for k, b in net.named_buffers():  # each run starts from the same buffers
            b.copy_(start[k])
        return {k: p.grad.double() for k, p in net.named_parameters()}

    def gap(g, ref):
        top = max(v.abs().max().item() for v in ref.values())
        return max((g[k] - ref[k]).abs().max().item()
                   / max(ref[k].abs().max().item(), 1e-3 * top) for k in ref)

    tape64 = _InputTape()
    g64 = grads(net64, tape64)
    masked = gap(grads(net32, ton.ReluTape(replay=tape64)), g64)
    tape32 = ton.ReluTape()
    own = gap(grads(net32, tape32), g64)
    flips, elements = tape32.flips(tape64)
    nearest = min(range(len(tape64.inputs)), key=lambda i: tape64.inputs[i].min().item())
    flipped = ton.ReluTape()
    flipped.masks = [m.contiguous().clone() for m in tape64.masks]
    at = int(tape64.inputs[nearest].reshape(-1).argmin())
    flipped.masks[nearest].view(-1)[at] ^= True
    one_flip = gap(grads(net64, ton.ReluTape(replay=flipped)), g64)
    print(f"f32 against f64: gradients on shared masks {masked:.3e}, on its own "
          f"{own:.3e}; {flips} of {elements:,} ReLU inputs change sign; one flip "
          f"(|x| = {tape64.inputs[nearest].min().item():.2e}) moves f64 by {one_flip:.3e}")
    assert masked <= grad_tol
    assert flips <= flip_tol * elements
    assert one_flip > grad_tol
