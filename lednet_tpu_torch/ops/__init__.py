from lednet_tpu_torch.ops.pool import (adaptive_avg_pool2d, avg_pool2d,
                                       global_avg_pool)
from lednet_tpu_torch.ops.resize import resize_bilinear, resize_nearest
