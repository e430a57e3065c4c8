"""What the UNets' one-rounding bf16 convolution costs on the card, by
the way its float32 sums are taken (PyTorch port, on the card).

On CUDA tensors a bf16 `CastConv` of either UNet runs through
`models/unet._RoundOnce`: a float32 convolution on the bf16 operands
that takes the bias into its sums and is rounded to bf16 once.  This
tool runs both UNets three ways in one process, in turns (A B C C B A):

* "bf16 cuDNN": the plain bf16 convolution (cuDNN rounds its sum to bf16
  and PyTorch adds the bias after it: two roundings);
* "float32 FFMA": `_RoundOnce` as shipped, cuDNN's TF32 off (CUDA-core
  sums, or cuDNN's float32 FFT);
* "TF32 sums": `_RoundOnce` with cuDNN's TF32 on for its float32
  convolution (tensor-core sums on the TF32-exact bf16 operands).

For each it prints every convolution's forward output against a float64
convolution on the card on the same bf16 operands: the relative L2 error
over the bf16 floor (the error of the float64 result rounded to bf16; 1.0
is one rounding) and the share of outputs that are not the float64
result correctly rounded.  Then the ms of: the articular UNet on a batch
of 8 x 512 x 512 (no grad) and its peak memory, a training step (16 x
512 x 512, `dice_bce_loss`, AdamW), the CT UNet on one 320 x 144 x 144
volume, and a CT training step (64 x 48 x 48); CUDA events, the card
spun first.  Last, the profiler's device kernels of one forward of
each UNet per rounding mode, flagged where a name says Winograd or FFT
(an algorithm that transforms the operands, which TF32 would round).

Run:  python tools/round_once_torch.py
"""

import contextlib
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np
import torch

from shoulder_tpu_torch.models import ct_unet, unet, unet_train
from shoulder_tpu_torch.pipeline import ct

BF16 = torch.bfloat16
SHIPPED_FORWARD = unet._RoundOnce.__dict__["forward"]
CAST_FORWARD = unet.CastConv.forward


def _tf32_forward(ctx, conv, x, weight, bias):
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        return SHIPPED_FORWARD.__func__(ctx, conv, x, weight, bias)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def _two_roundings(self, x):
    dt = self.compute_dtype
    return self._conv_forward(x.to(dt), self.weight.to(dt), self.bias.to(dt))


MODES = {"bf16 cuDNN": (CAST_FORWARD, _two_roundings),
         "float32 FFMA": (SHIPPED_FORWARD, None),
         "TF32 sums": (staticmethod(_tf32_forward), None)}


@contextlib.contextmanager
def mode(name):
    fwd, cast = MODES[name]
    if cast is None:
        unet._RoundOnce.forward = fwd
    else:
        unet.CastConv.forward = cast
    try:
        yield
    finally:
        unet._RoundOnce.forward = SHIPPED_FORWARD
        unet.CastConv.forward = CAST_FORWARD


def timed(fn, reps):
    """Mean ms per call over `reps` calls by CUDA events, the card spun
    first so the host enqueues ahead of it."""
    fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(100_000_000)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def layer_errors(model, run):
    """[(name, error over the bf16 floor, share not correctly rounded)]
    for every CastConv of `model` over one call of run()."""
    names = {m: n for n, m in model.named_modules()}
    seen = []
    hooks = [m.register_forward_hook(
        lambda m, i, o: seen.append((m, i[0].detach(), o.detach())))
        for m in model.modules() if isinstance(m, unet.CastConv)]
    try:
        with torch.no_grad():
            run()
    finally:
        for h in hooks:
            h.remove()
    out = []
    with torch.no_grad():
        for m, x, y in seen:
            ref = m._conv_forward(x.to(BF16).double(),
                                  m.weight.to(BF16).double(),
                                  m.bias.to(BF16).double())
            rounded = ref.to(BF16)
            norm = ref.norm()
            floor = float((rounded.double() - ref).norm() / norm)
            err = float((y.double() - ref).norm() / norm)
            out.append((names[m], err / floor,
                        float((y != rounded).double().mean())))
    return out


def device_kernels(run):
    """[(kernel name, device ms)] of every device kernel of one call of
    run(), the largest first."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.no_grad(), torch.profiler.profile(activities=acts) as prof:
        run()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    return sorted(rows, key=lambda r: -r[1])


def main():
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"{smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"cuDNN {torch.backends.cudnn.version()}, cuDNN TF32 outside "
          f"_RoundOnce {torch.backends.cudnn.allow_tf32}", flush=True)

    gen = torch.Generator(device=dev).manual_seed(0)
    images8, _ = unet_train.synth_polar_batch(gen, 8, 512)
    images16, labels16 = unet_train.synth_polar_batch(gen, 16, 512)
    model2d = unet.load_model(dev)
    flat2d = unet.load_flat(unet.DEFAULT_NPZ)
    model3d = ct_unet.load_model(dev)
    flat3d = ct_unet.load_params()
    vol, _, _ = ct.synth_ct_volume(shape=(320, 144, 144),
                                   spacing=(1.0, 1.0, 1.0))
    vol = torch.as_tensor(vol, device=dev)
    small, _, _ = ct.synth_ct_volume(shape=(64, 48, 48),
                                     spacing=(300.0 / 64, 1.8, 1.8), seed=1)
    small = torch.as_tensor(small, device=dev)[None, None] / ct_unet.HU_SCALE
    small_lab = (small * ct_unet.HU_SCALE > 350.0).float()

    def unet_step(flat, model_from_flat, loss_fn, x, y):
        model = model_from_flat(flat, serving=False).to(dev)
        opt = unet_train.adamw(model, 1e-4)
        return lambda: unet_train.train_step(model, opt, loss_fn, x, y)

    results = {name: [] for name in MODES}
    order = list(MODES) + list(reversed(MODES))
    for turn, name in enumerate(order):
        with mode(name):
            row = {}
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            with torch.no_grad():
                model2d(images8)
            torch.cuda.synchronize()
            row["unet_peak_mib"] = (torch.cuda.max_memory_allocated()
                                    - base) / 2**20
            with torch.no_grad():
                row["unet_ms"] = timed(lambda: model2d(images8), 10)
                row["ct_ms"] = timed(
                    lambda: ct_unet.apply_volume(model3d, vol), 5)
            row["step_ms"] = timed(unet_step(
                flat2d, unet.model_from_flat, unet_train.dice_bce_loss,
                images16, labels16), 10)
            row["ct_step_ms"] = timed(unet_step(
                flat3d, ct_unet.model_from_flat, unet_train.bce_loss,
                small, small_lab), 10)
            results[name].append(row)
            print(f"turn {turn} {name}: " + ", ".join(
                f"{k} {v:.3f}" for k, v in row.items()), flush=True)
            if turn < len(MODES):
                for label, model, run in (
                        ("UNet, 2 x 512 x 512",
                         model2d, lambda: model2d(images8[:2])),
                        ("CT UNet, 64 x 48 x 48",
                         model3d, lambda: model3d(small))):
                    errs = layer_errors(model, run)
                    worst = max(errs, key=lambda e: e[1])
                    print(f"  {label}: {len(errs)} convolutions, error over "
                          f"the bf16 floor {min(e[1] for e in errs):.4f}-"
                          f"{worst[1]:.4f} (worst {worst[0]}), not correctly "
                          f"rounded at most "
                          f"{max(e[2] for e in errs):.2e}", flush=True)
                    for n, ratio, off in errs:
                        print(f"    {n:28s} {ratio:.4f} {off:.2e}")
                for label, run in (
                        ("UNet 8 x 512 x 512", lambda: model2d(images8)),
                        ("CT UNet 320 x 144 x 144",
                         lambda: ct_unet.apply_volume(model3d, vol))):
                    rows = device_kernels(run)
                    flagged = [k for k, _ in rows if "winograd" in k.lower()
                               or "fft" in k.lower()]
                    print(f"  {label}: {len(rows)} device kernels, "
                          f"{sum(ms for _, ms in rows):.2f} ms; Winograd or "
                          f"FFT: {flagged or 'none'}", flush=True)
                    for k, ms in rows[:8]:
                        print(f"    {ms:8.3f} ms  {k[:110]}")
    print(f"medians of 2 turns each ({smi}):")
    for name, rows in results.items():
        print(f"  {name:14s} " + ", ".join(
            f"{k} {np.median([r[k] for r in rows]):.3f}" for k in rows[0]))


if __name__ == "__main__":
    main()
