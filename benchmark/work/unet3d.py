"""The CT 3D UNet over one volume (models/ct_unet.py): bf16
convolutions, counted from the volume's shape (work/_conv.py)."""

from benchmark.work._conv import unet_work

HOOKS = (("models.ct_unet", "apply_volume"),)
PRECISION = "bf16"
RANGES = ("apply_volume",)
KERNELS = ()


def work(fn, args, kwargs, result):
    model, volume = args[0], args[1]
    return unet_work(tuple(volume.shape), tuple(model.features), 3)
