"""Dataset class-name and palette tables of the datasets the port reads.

The port's copy of the tables it needs from ``lednet_tpu/datasets/metainfo.py``
(Cityscapes, fixed by its official label spec, :352-363) and of the fork's
2-class VOC task (``lednet_tpu/datasets/basesegdataset.py:161``).
"""

CITYSCAPES_CLASSES = (
    'road', 'sidewalk', 'building', 'wall', 'fence', 'pole',
    'traffic light', 'traffic sign', 'vegetation', 'terrain', 'sky',
    'person', 'rider', 'car', 'truck', 'bus', 'train', 'motorcycle',
    'bicycle',)
CITYSCAPES_PALETTE = [
    [128, 64, 128], [244, 35, 232], [70, 70, 70], [102, 102, 156],
    [190, 153, 153], [153, 153, 153], [250, 170, 30], [220, 220, 0],
    [107, 142, 35], [152, 251, 152], [70, 130, 180], [220, 20, 60],
    [255, 0, 0], [0, 0, 142], [0, 0, 70], [0, 60, 100], [0, 80, 100],
    [0, 0, 230], [119, 11, 32]]

APPLE_BRANCH_CLASSES = ('background', 'branch')
APPLE_BRANCH_PALETTE = [[0, 0, 0], [128, 0, 0]]
