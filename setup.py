from setuptools import find_packages, setup

setup(
    name='lednet_tpu',
    version='0.1.0',
    description='TPU-native (JAX/XLA/Pallas/pjit) real-time semantic '
                'segmentation framework with the capabilities of '
                'ly27253/LED-Net',
    packages=find_packages(include=['lednet_tpu', 'lednet_tpu.*',
                                    'lednet_tpu_torch', 'lednet_tpu_torch.*']),
    python_requires='>=3.10',
    install_requires=[
        'jax', 'flax', 'optax', 'orbax-checkpoint', 'numpy',
        'opencv-python', 'pillow',
    ],
    include_package_data=True,
    package_data={'lednet_tpu': ['native/*.cpp', 'models/text_encoder/data/*.gz'],
                  'lednet_tpu_torch': ['csrc/*.cu', 'csrc/*.cuh', 'native/*.cpp',
                                       'models/text_encoder/data/*.gz']},
)
