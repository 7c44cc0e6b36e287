"""The port's hand-written CUDA kernels (sources in ``lednet_tpu_torch/csrc``),
each beside its plain PyTorch version and a count of launches.

Every op takes ``impl``: ``None`` runs the kernel on a CUDA tensor and the
plain version on a CPU tensor; ``'cuda'`` on a CPU tensor raises; a build or
launch failure raises.  Nothing falls back.  A launch counted in
``<op>.launches`` is one call of the op (kernel D is two CUDA launches per
call, kernel B one, kernel C two, kernel E one).  A call made while a CUDA
graph is captured counts too: its launch is recorded into the graph.  A
replay of the graph calls no op, so no wrapper counts it;
:func:`device_launches` counts the kernels that ran, replayed or not, from a
device trace.  Kernel E (``sesp_pyramid``) is on no model path: no model of
either package calls it.
"""
from lednet_tpu_torch.ops.kernels.conv_block import basic_pair
from lednet_tpu_torch.ops.kernels.normalize import normalize_image
from lednet_tpu_torch.ops.kernels.sesp_pyramid import sesp_block, sesp_pyramid
from lednet_tpu_torch.ops.kernels.stem_conv import stem_convs

KERNELS = (normalize_image, stem_convs, basic_pair, sesp_block, sesp_pyramid)
# each op's __global__ functions in lednet_tpu_torch/csrc
DEVICE_FUNCTIONS = {
    'normalize_image': ('normalize_kernel',),
    'stem_convs': ('stem_fused_kernel',),
    'basic_pair': ('basic_block_kernel',),
    'sesp_block': ('sesp_reduce_kernel', 'sesp_fused_kernel'),
    'sesp_pyramid': ('pyramid_ring_kernel',),
}


def reset_launch_counts() -> None:
    for op in KERNELS:
        op.launches = 0


def launch_counts() -> dict:
    return {op.__name__: op.launches for op in KERNELS}


def device_launches(events) -> dict:
    """The CUDA kernels of each op that ran on the device, by op, counted
    from the device events of a ``torch.profiler`` trace
    (``prof.key_averages()``) by function name.  CUPTI traces a kernel
    that a CUDA graph replays like any other."""
    from torch.autograd import DeviceType
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    return {op: sum(e.count for e in device for fn in fns
                    if f'lednet::{fn}' in e.key)
            for op, fns in DEVICE_FUNCTIONS.items()}
