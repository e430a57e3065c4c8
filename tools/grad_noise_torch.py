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
the card) the ms of one forward and backward by CUDA events.

Then, where the card's bf16 gradient parts from the CPU's: every
parameter's card-vs-CPU distance in bf16, from the head back (the order
backward reaches the layers), beside each device's distance from its own
float32 gradient; and each layer alone, forward and backward, from the
same input and the same upstream gradient (both recorded in the CPU's
bf16 step), on the card and on the CPU, each held against the same
layer in float64 on the bf16-rounded operands.  That names the operation whose
arithmetic differs: a bf16 convolution's weight or input gradient
(cuDNN on the card), a GroupNorm backward (float32), or the casts around
them.  Last it profiles three default bf16 steps and prints the device
kernels that take most of the time, by name.

Run:  python tools/grad_noise_torch.py [--batch 16] [--size 512] [--no-cpu]
"""

import argparse
import contextlib
import copy
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch
from torch import nn

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


def backward_order(model):
    """(name, module) of the model's convolutions and group norms in the
    order backward reaches them: the reverse of the forward's."""
    names = {m: n for n, m in model.named_modules()}
    seen = []
    hooks = [m.register_forward_hook(lambda m, i, o: seen.append(m))
             for m in model.modules()
             if isinstance(m, (nn.Conv2d, nn.GroupNorm))]
    with torch.no_grad():
        model(torch.zeros((1, 1, 16, 16), device=next(model.parameters())
                          .device))
    for h in hooks:
        h.remove()
    return [(names[m], m) for m in reversed(seen)]


def rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def per_parameter(flat, card_bf16, cpu_bf16, card_f32, cpu_f32, smi):
    """Each parameter's card-vs-CPU bf16 distance, from the head back."""
    model = unet.model_from_flat(flat, serving=False)
    print(f"bf16 gradient per parameter, from the head back ({smi}): "
          f"card vs cpu | card vs its float32 | cpu vs its float32")
    rows = []
    for name, mod in backward_order(model):
        for p in ("weight", "bias"):
            key = f"{name}.{p}"
            row = (key, rel(card_bf16[key], cpu_bf16[key]),
                   rel(card_bf16[key], card_f32[key]),
                   rel(cpu_bf16[key], cpu_f32[key]))
            rows.append(row)
            print(f"  {key:28s} {row[1]:9.4g} | {row[2]:9.4g} | "
                  f"{row[3]:9.4g}")
    return rows


def record_layers(flat, images, labels):
    """The CPU's bf16 step, recording each layer's input and the gradient
    of the loss with respect to its output: {name: (module, x, g)}."""
    model = unet.model_from_flat(flat, torch.bfloat16, serving=False)
    order = backward_order(model)
    seen = {}

    def hook(name):
        def fwd(mod, inputs, out):
            seen[name] = [mod, inputs[0].detach(), None]
            out.register_hook(lambda g: seen[name].__setitem__(2, g))
        return fwd

    hooks = [m.register_forward_hook(hook(n)) for n, m in order]
    loss = unet_train.dice_bce_loss(model, images, labels)
    loss.backward()
    for h in hooks:
        h.remove()
    return order, seen


def layer_grads(mod, x, g, device, exact=False):
    """(output, input gradient, weight gradient) of `mod` alone at input x and
    upstream gradient g on `device`; `exact`: in float64 on the operands
    the bf16 step rounded (the convolution's input and weight)."""
    mod = copy.deepcopy(mod).to(device)
    x, g = x.to(device), g.to(device)
    if exact:
        dt = getattr(mod, "compute_dtype", None)
        if dt is not None:
            x = x.to(dt)
            with torch.no_grad():
                for p in mod.parameters():
                    p.copy_(p.to(dt))
            mod.compute_dtype = torch.float64
        mod, x, g = mod.double(), x.double(), g.double()
    x = x.requires_grad_()
    y = mod(x)
    gx, gw = torch.autograd.grad(y, [x, mod.weight], g)
    return y.detach(), gx, gw


def per_layer(order, seen, card, smi):
    """Each layer alone on the card and on the CPU against float64;
    prints relative L2 errors of the output and of the input and weight
    gradients, and the rounding floor of each."""
    print(f"each layer alone (forward output, input and weight gradients), "
          f"relative L2 from float64 on the "
          f"same operands, from the head back ({smi}):\n"
          f"  layer                        kind      | output card  cpu   "
          f"floor | d input card  cpu   floor | d weight card  cpu   floor")
    rows = []
    for name, _ in order:
        mod, x, g = seen[name]
        ref = layer_grads(mod, x, g, card, exact=True)
        got = {d: layer_grads(mod, x, g, d) for d in (card, "cpu")}
        kind = ("bf16 conv" if isinstance(mod, unet.CastConv)
                else "conv" if isinstance(mod, nn.Conv2d) else "groupnorm")
        # a bf16 convolution's gradients are bf16 before their casts
        fdt = getattr(mod, "compute_dtype", torch.float32)
        err = [[rel(got[d][k].cpu(), ref[k].cpu()) for d in (card, "cpu")]
               + [rel(ref[k].to(fdt).cpu(), ref[k].cpu())]
               for k in (0, 1, 2)]
        rows.append((name, kind, err))
        print(f"  {name:28s} {kind:9s} | " + " | ".join(
            " ".join(f"{e:8.3g}" for e in part) for part in err))
    return rows


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
        if not flags:
            card_bf16 = got
    if not args.no_cpu:
        cpu = {}
        for name, dtype in (("cpu float32", torch.float32),
                            ("cpu bf16", torch.bfloat16)):
            loss, cpu[dtype], _ = grads(flat, images, labels, "cpu", dtype)
            whole, worst, where = distance(cpu[dtype], ref)
            print(f"{name}: loss {loss:.6f}, whole gradient {whole:.3g} from "
                  f"the reference, largest {worst:.3g} ({where})")
        per_parameter(flat, card_bf16, cpu[torch.bfloat16], ref,
                      cpu[torch.float32], smi)
        order, seen = record_layers(flat, images.cpu(), labels.cpu())
        per_layer(order, seen, dev, smi)
        del seen

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
