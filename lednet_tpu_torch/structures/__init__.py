from lednet_tpu_torch.structures.sampler import OHEMPixelSampler

__all__ = ['OHEMPixelSampler']
