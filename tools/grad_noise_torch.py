"""How far the articular UNet's bf16 gradient lies from its float32 one
at the shipped weights, per cuDNN setting, and where a training step's
device time goes (PyTorch port, on the card).

At trained weights the gradient is a small residual of sums that cancel,
so the rounding of the bf16 convolutions moves it far more than it moves
the loss.  One fixed procedural batch (16 x 512 x 512, seed 0) goes
through `dice_bce_loss` and `backward` from models/params/unet.npz:

* in float32 on the card (cuDNN's TF32 off): the reference;
* in bf16 on the card under cuDNN's default heuristics, with
  `cudnn.deterministic`, with `cudnn.benchmark`, and with cuDNN off
  (PyTorch's own convolution kernels);
* in bf16 and in float32 on the CPU.

For each it prints the loss, the whole gradient's relative L2 distance
from the reference, the largest distance over the parameters, and (on
the card) the ms of one forward and backward by CUDA events.  Then it
profiles three default bf16 steps and prints the device kernels that
take most of the time, by name.

Run:  python tools/grad_noise_torch.py [--batch 16] [--size 512] [--no-cpu]
"""

import argparse
import contextlib
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch

from shoulder_tpu_torch.models import unet, unet_train


def grads(flat, images, labels, device, dtype, reps=0):
    """(loss, {name: gradient on the host}, ms per forward and backward or
    None) from the flat weights on `device`."""
    model = unet.model_from_flat(flat, dtype, serving=False).to(device)
    images, labels = images.to(device), labels.to(device)

    def run():
        model.zero_grad(set_to_none=True)
        loss = unet_train.dice_bce_loss(model, images, labels)
        loss.backward()
        return loss

    loss = run()
    ms = None
    if reps:
        run()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            run()
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / reps
    return (loss.item(),
            {n: p.grad.cpu() for n, p in model.named_parameters()}, ms)


@contextlib.contextmanager
def cudnn(**flags):
    old = {k: getattr(torch.backends.cudnn, k) for k in flags}
    for k, v in flags.items():
        setattr(torch.backends.cudnn, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(torch.backends.cudnn, k, v)


def distance(got, ref):
    """(whole-gradient relative L2, largest per-parameter one, its name)."""
    x, y = (torch.cat([g[n].flatten() for n in ref]).double()
            for g in (got, ref))
    rel = {n: float((got[n] - ref[n]).norm() / ref[n].norm()) for n in ref}
    worst = max(rel, key=rel.get)
    return float((x - y).norm() / y.norm()), rel[worst], worst


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--no-cpu", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("grad_noise_torch: no CUDA device")
    dev = torch.device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"{smi}; torch {torch.__version__}, cuDNN "
          f"{torch.backends.cudnn.version()}, cuDNN TF32 "
          f"{torch.backends.cudnn.allow_tf32}")

    flat = unet_train.load_params()
    gen = torch.Generator(device=dev).manual_seed(0)
    images, labels = unet_train.synth_polar_batch(gen, args.batch, args.size)

    loss, ref, ms = grads(flat, images, labels, dev, torch.float32, reps=5)
    print(f"card float32 (reference): loss {loss:.6f}, gradient norm "
          f"{float(torch.cat([g.flatten() for g in ref.values()]).norm()):.4g}"
          f", {ms:.2f} ms per forward and backward")
    variants = [("card bf16, cuDNN default", {}),
                ("card bf16, cudnn.deterministic", {"deterministic": True}),
                ("card bf16, cudnn.benchmark", {"benchmark": True}),
                ("card bf16, cuDNN off", {"enabled": False})]
    for name, flags in variants:
        with cudnn(**flags):
            loss, got, ms = grads(flat, images, labels, dev, torch.bfloat16,
                                  reps=5)
        whole, worst, where = distance(got, ref)
        print(f"{name}: loss {loss:.6f}, whole gradient {whole:.3g} from the "
              f"reference, largest {worst:.3g} ({where}), {ms:.2f} ms per "
              f"forward and backward ({smi})")
    if not args.no_cpu:
        for name, dtype in (("cpu float32", torch.float32),
                            ("cpu bf16", torch.bfloat16)):
            loss, got, _ = grads(flat, images, labels, "cpu", dtype)
            whole, worst, where = distance(got, ref)
            print(f"{name}: loss {loss:.6f}, whole gradient {whole:.3g} from "
                  f"the reference, largest {worst:.3g} ({where})")

    # where a training step's device time goes
    model = unet.model_from_flat(flat, serving=False).to(dev)
    optimizer = unet_train.adamw(model, 3e-4)
    step_args = (model, optimizer, unet_train.dice_bce_loss, images, labels)
    for _ in range(2):
        unet_train.train_step(*step_args)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    steps = 3
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            unet_train.train_step(*step_args)
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3 / steps, e.count // steps)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(ms for _, ms, _ in rows)
    print(f"profiled training step, bf16, cuDNN default: {total:.2f} ms of "
          f"device time per step in {sum(n for _, _, n in rows)} kernels "
          f"({smi}); the largest:")
    for key, ms, n in sorted(rows, key=lambda r: -r[1])[:14]:
        print(f"  {ms:8.3f} ms  {100 * ms / total:5.1f} %  x{n:<4d} {key[:110]}")


if __name__ == "__main__":
    main()
