"""The Siamese verification head (port of
``reid_gan_tpu/models/embedding.py``; parity: FD/reid/models/
embedding.py:26-39)."""

import torch
from torch import nn


class EltwiseSubEmbed(nn.Module):
    """(x1 − x2) → square or abs → optional BatchNorm1d (torch momentum 0.1,
    flax's 0.9) → the ``classifier`` logits (N(0, 0.001) init) or the sum
    over features. The stage-I baseline is square, BN, classifier 2048 → 2
    (FD/baseline.py:97-99)."""

    def __init__(self, nonlinearity="square", use_batch_norm=False,
                 use_classifier=False, num_features=0, num_classes=0):
        super().__init__()
        if nonlinearity not in (None, "square", "abs"):
            raise KeyError(f"Unknown nonlinearity: {nonlinearity}")
        self.nonlinearity = nonlinearity
        self.bn = nn.BatchNorm1d(num_features) if use_batch_norm else None
        self.classifier = None
        if use_classifier:
            self.classifier = nn.Linear(num_features, num_classes)
            nn.init.normal_(self.classifier.weight, std=0.001)
            nn.init.zeros_(self.classifier.bias)

    def forward(self, x1, x2):
        x = x1 - x2
        if self.nonlinearity == "square":
            x = x * x
        elif self.nonlinearity == "abs":
            x = torch.abs(x)
        if self.bn is not None:
            x = self.bn(x)
        if self.classifier is not None:
            return self.classifier(x)
        return torch.sum(x, dim=1)
