"""The Siamese wrapper of FD-GAN (port of
``reid_gan_tpu/models/multi_branch.py``; parity: FD/reid/models/
multi_branch.py:12-15)."""

from torch import nn

from .embedding import EltwiseSubEmbed
from .resnet import FDResNet


class SiameseNet(nn.Module):
    """One weight-tied base on both inputs, then the verification head:
    (x1, x2) → (f1, f2, logits), or (f1, f2) without a head."""

    def __init__(self, base_model, embed_model=None):
        super().__init__()
        self.base_model = base_model
        self.embed_model = embed_model

    def forward(self, x1, x2):
        f1 = self.base_model(x1)
        f2 = self.base_model(x2)
        if self.embed_model is None:
            return f1, f2
        return f1, f2, self.embed_model(f1, f2)


def siamese_net(depth=50, num_classes=2):
    """Cut-at-pooling FDResNet + EltwiseSubEmbed(square, BN, classifier
    D → ``num_classes``), D 2048 at depth 50 and above, else 512
    (FD/baseline.py:96-99; FDGANModel's E has 2 classes, Di 1)."""
    nfeat = 2048 if depth >= 50 else 512
    return SiameseNet(FDResNet(depth=depth, cut_at_pooling=True),
                      EltwiseSubEmbed(nonlinearity="square", use_batch_norm=True,
                                      use_classifier=True, num_features=nfeat,
                                      num_classes=num_classes))


def siamese_baseline(depth=50):
    """The stage-I verification baseline (multi_branch.py:26-33): the
    2-class Siamese net."""
    return siamese_net(depth, num_classes=2)
