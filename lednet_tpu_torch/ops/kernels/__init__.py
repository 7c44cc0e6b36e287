"""The port's hand-written CUDA kernels (sources in ``lednet_tpu_torch/csrc``),
each beside its plain PyTorch version and a count of launches.

Every op takes ``impl``: ``None`` runs the kernel on a CUDA tensor and the
plain version on a CPU tensor; ``'cuda'`` on a CPU tensor raises; a build or
launch failure raises.  Nothing falls back.  A launch counted in
``<op>.launches`` is one call of the op (kernel D is two CUDA launches per
call, kernel B one, kernel C two, kernel E one).  Kernel E (``sesp_pyramid``)
is on no model path: no model of either package calls it.
"""
from lednet_tpu_torch.ops.kernels.conv_block import basic_pair
from lednet_tpu_torch.ops.kernels.normalize import normalize_image
from lednet_tpu_torch.ops.kernels.sesp_pyramid import sesp_block, sesp_pyramid
from lednet_tpu_torch.ops.kernels.stem_conv import stem_convs

KERNELS = (normalize_image, stem_convs, basic_pair, sesp_block, sesp_pyramid)


def reset_launch_counts() -> None:
    for op in KERNELS:
        op.launches = 0


def launch_counts() -> dict:
    return {op.__name__: op.launches for op in KERNELS}
