from setuptools import find_packages, setup

setup(
    name='paddle_tpu',
    version='0.1.0',
    description='TPU-native deep learning framework with PaddlePaddle API parity',
    packages=find_packages(include=['paddle_tpu*']),
    # 'paddle_tpu*' also takes paddle_tpu_torch, the PyTorch/CUDA port. It
    # builds its CUDA kernels from these sources with nvcc at first use,
    # into paddle_tpu_torch/_build/: run it from a checkout (or an editable
    # install), where that directory is writable
    package_data={'paddle_tpu_torch': ['csrc/*.cu', 'csrc/*.cuh']},
    python_requires='>=3.10',
    install_requires=['jax', 'numpy'],
)
