"""The 2D UNet over the batch's polar images (models/unet.py): bf16
convolutions, counted from the image shape (work/_conv.py)."""

from benchmark.work._conv import unet_work

HOOKS = (("models.unet", "segment_image"),)
PRECISION = "bf16"
RANGES = ("segment_image",)
KERNELS = ()
FEATURES = (16, 32, 64, 128)


def work(fn, args, kwargs, result):
    model, image = args[0], args[1]
    h, w = image.shape[-2:]
    n = image.numel() // (h * w)
    return unet_work((h, w), tuple(model.features), 2, batch=n)
