import os

from setuptools import find_packages, setup


def read_version():
    path = os.path.join(os.path.dirname(__file__), "whisper_at_tpu", "version.py")
    scope = {}
    with open(path) as f:
        exec(f.read(), scope)
    return scope["__version__"]


setup(
    name="whisper-at-tpu",
    version=read_version(),
    description=(
        "TPU-native Whisper-AT: joint automatic speech recognition and "
        "AudioSet audio tagging on JAX/XLA"
    ),
    readme="README.md",
    python_requires=">=3.10",
    packages=find_packages(exclude=["tests*", "tools*"]),
    include_package_data=True,
    package_data={
        "whisper_at_tpu": ["assets/*", "normalizers/english.json"],
        "whisper_at_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"],
    },
    install_requires=[
        "jax",
        "numpy",
        "regex",
        "tqdm",
        "scipy",
        "more-itertools",
    ],
    extras_require={
        "train": ["optax", "scikit-learn"],
        "dev": ["pytest", "torch", "scikit-learn", "optax"],
        "demo": ["gradio"],
    },
    entry_points={
        "console_scripts": [
            "whisper_at_tpu=whisper_at_tpu.transcribe:cli",
            "whisper_at_tpu_serve=whisper_at_tpu.serving:main",
            "whisper_at_tpu_torch=whisper_at_tpu_torch.cli:cli",
        ],
    },
)
