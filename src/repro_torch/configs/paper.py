"""The paper's own experiment configurations (Tables 1-3).

The port's copy of ``repro.configs.paper``, field for field: the ResNet
and DDPM training setups as published (datasets, image sizes, learning
rates, epochs, batch sizes). The data layer substitutes the datasets,
which are not downloaded, with shape-identical deterministic streams
(:class:`repro_torch.data.pipeline.ImagePipeline`).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PaperTask:
    task: str            # classification | generation
    dataset: str
    model: str           # resnet18 | resnet26 | resnet50 | ddpm
    image: tuple[int, int, int]
    n_classes: int
    lr: float
    epochs: int
    batch: int
    timesteps: int = 0   # DDPM only


CLASSIFICATION = {
    ("mnist", "resnet18"): PaperTask("classification", "mnist", "resnet18", (1, 28, 28), 10, 2e-4, 50, 128),
    ("mnist", "resnet50"): PaperTask("classification", "mnist", "resnet50", (1, 28, 28), 10, 2e-4, 50, 128),
    ("fashionmnist", "resnet18"): PaperTask("classification", "fashionmnist", "resnet18", (1, 28, 28), 10, 2e-4, 50, 128),
    ("fashionmnist", "resnet50"): PaperTask("classification", "fashionmnist", "resnet50", (1, 28, 28), 10, 2e-4, 50, 128),
    ("cifar10", "resnet18"): PaperTask("classification", "cifar10", "resnet18", (3, 32, 32), 10, 2e-4, 50, 128),
    ("cifar10", "resnet50"): PaperTask("classification", "cifar10", "resnet50", (3, 32, 32), 10, 2e-4, 250, 128),
    ("cifar100", "resnet18"): PaperTask("classification", "cifar100", "resnet18", (3, 32, 32), 100, 2e-4, 50, 128),
    ("cifar100", "resnet50"): PaperTask("classification", "cifar100", "resnet50", (3, 32, 32), 100, 2e-4, 250, 128),
    ("celeba", "resnet18"): PaperTask("classification", "celeba", "resnet18", (3, 64, 64), 40, 2e-4, 50, 128),
    ("celeba", "resnet50"): PaperTask("classification", "celeba", "resnet50", (3, 64, 64), 40, 2e-4, 50, 32),
    ("imagenet1k", "resnet18"): PaperTask("classification", "imagenet1k", "resnet18", (3, 224, 224), 1000, 2e-4, 50, 32),
    ("imagenet1k", "resnet50"): PaperTask("classification", "imagenet1k", "resnet50", (3, 224, 224), 1000, 2e-4, 50, 16),
}

GENERATION = {
    "mnist": PaperTask("generation", "mnist", "ddpm", (1, 28, 28), 0, 1e-3, 300, 128, timesteps=200),
    "fashionmnist": PaperTask("generation", "fashionmnist", "ddpm", (1, 28, 28), 0, 1e-3, 500, 128, timesteps=200),
    "celeba": PaperTask("generation", "celeba", "ddpm", (3, 64, 64), 0, 2e-4, 200, 128, timesteps=1000),
}
