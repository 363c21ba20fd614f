"""ArcFace identity loss (counterpart of losses/id_loss.py). Crops the face
region [35s:-33s, 32s:-36s] (s = h // 256), adaptive-average-pools it to
112 x 112, embeds it with IR-SE-50 and penalizes 1 - cos(y_hat, y). The
MIMO mode adds the cross-output reference term keyed by each view's
quality score. Inputs are NHWC, like the JAX loss. Also ArcFaceLoss, the
reference's grayscale ResNetArcFace loss."""

import torch
from torch import nn

from ..nn.arcface_resnet import ResNetArcFace
from ..nn.irse import ArcFaceBackbone
from ..ops.resize import adaptive_avg_pool, resize_bilinear


class IDLoss(nn.Module):
    """A loss with a frozen net: `facenet` holds the ArcFace weights; `ckpt`
    names them for a loader."""

    def __init__(self, loss_weight=1.0, ref_loss_weight=1.0, reduce="mean",
                 ckpt=None, **kwargs):
        super().__init__()
        self.loss_weight, self.ref_loss_weight = loss_weight, ref_loss_weight
        self.reduce, self.ckpt = reduce, ckpt
        self.facenet = ArcFaceBackbone(num_layers=50)

    def extract_feats(self, x):
        """(B, 512) embeddings of the NHWC batch x."""
        x = x.permute(0, 3, 1, 2)
        ss = x.shape[2] // 256
        if ss >= 1:
            x = x[:, :, 35 * ss:-33 * ss, 32 * ss:-36 * ss]
        return self.facenet(adaptive_avg_pool(x, (112, 112)))

    def forward(self, y_hat, y, x, mimo_id=False, score=None):
        """Non-MIMO: (B, H, W, C) images; MIMO: (B, K, H, W, C) with score
        (B, K). The target's embedding carries no gradient. Returns (loss,
        reference term)."""
        if not mimo_id:
            yh = self.extract_feats(y_hat)
            yf = self.extract_feats(y).detach()
            loss = self.loss_weight * (1.0 - (yh * yf).sum(dim=-1)).mean()
            return loss, torch.zeros((), device=loss.device)
        if score is None:
            raise ValueError("the MIMO identity loss needs the batch's lq_size scores")
        b, k = y_hat.shape[:2]
        yh = self.extract_feats(y_hat.flatten(0, 1)).reshape(b, k, -1)
        yf = self.extract_feats(y.flatten(0, 1)).detach().reshape(b, k, -1)
        diff_target = 1.0 - (yh * yf).sum(dim=-1)                       # (B, K)
        idx_score = torch.argmax(score, dim=-1)                          # (B,)
        idx_best = torch.argmin(diff_target, dim=-1)
        # cross-output term: D[r, c] = 1 - <yh_r, yh_c (detached)>, minus diag
        d = 1.0 - torch.einsum("bkf,blf->bkl", yh, yh.detach())
        diff = d - torch.diagonal(d, dim1=1, dim2=2)[:, None, :]
        col_a = torch.take_along_dim(diff, idx_score[:, None, None], dim=2)[..., 0]
        col_b = torch.take_along_dim(diff, idx_best[:, None, None], dim=2)[..., 0]
        per_b = torch.where(idx_score == idx_best, col_a.mean(dim=1),
                            (col_a.mean(dim=1) + col_b.mean(dim=1)) / 2)
        ref = self.ref_loss_weight * per_b.mean()
        red = diff_target.mean() if self.reduce == "mean" else diff_target.sum()
        return self.loss_weight * red, ref


class ArcFaceLoss(nn.Module):
    """The reference's grayscale ArcFace loss (no shipped config uses it):
    both NHWC images to gray, resized to 128px, embedded by ResNetArcFace
    (IRBlock [2, 2, 2, 2]); loss_weight * mean |e(y_hat) - e(y)|, the
    target's embedding carrying no gradient. The reference's method is
    misspelled (`foward`) and so never runs; these are its working
    semantics, as JAX's."""

    def __init__(self, loss_weight=1.0, block="IRBlock", layers=(2, 2, 2, 2), use_se=False,
                 ckpt=None, **kwargs):
        super().__init__()
        if block != "IRBlock":
            raise ValueError("the reference wires IRBlock only")
        self.loss_weight, self.ckpt = loss_weight, ckpt
        self.facenet = ResNetArcFace(layers=tuple(layers), use_se=use_se)

    @staticmethod
    def gray_resize_for_identity(x, size=128):
        """(B, H, W, 3) -> (B, 1, size, size) luma, bilinear."""
        gray = 0.2989 * x[..., 0] + 0.5870 * x[..., 1] + 0.1140 * x[..., 2]
        return resize_bilinear(gray[:, None], (size, size))

    def forward(self, y_hat, y):
        e_hat = self.facenet(self.gray_resize_for_identity(y_hat))
        e = self.facenet(self.gray_resize_for_identity(y)).detach()
        return self.loss_weight * torch.abs(e_hat - e).mean()
