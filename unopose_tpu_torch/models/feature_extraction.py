"""2D features lifted to point clouds (counterpart of
``unopose_tpu/models/feature_extraction.py``): ViT pyramid + linear or
transposed-convolution upscaler, bilinear sampling at the observed pixels,
radius normalisation and template FPS, or the template's cached outputs."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from unopose_tpu_torch.models.layers import Dense, LayerNorm
from unopose_tpu_torch.models.vit import make_vit
from unopose_tpu_torch.ops.fps import gather_points, sample_pts_feats


def get_chosen_pixel_feats(feat_map: torch.Tensor, choose: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) map at flat (B, P) indices into the H*W grid -> (B, P, C)."""
    B, H, W, C = feat_map.shape
    return gather_points(feat_map.reshape(B, H * W, C), choose)


def bilinear_gather(feat_map: torch.Tensor, choose: torch.Tensor, out_size: int) -> torch.Tensor:
    """Bilinear samples of a (B, g, g, C) map at the pixel centres of flat
    indices into a virtual (out_size, out_size) grid (half-pixel centres,
    edge clamp: align_corners=False), computed in the map's dtype."""
    B, g, g2, C = feat_map.shape
    if g != g2:
        raise ValueError(f"square feature map expected, got {g}x{g2}")
    flat = feat_map.reshape(B, g * g, C)
    choose = choose.long()
    r = torch.div(choose, out_size, rounding_mode="floor").float()
    c = (choose % out_size).float()
    scale = g / out_size

    def src(v):
        s = torch.clamp((v + 0.5) * scale - 0.5, 0.0, g - 1.0)
        lo = torch.clamp(torch.floor(s), 0, g - 1)
        hi = torch.clamp_max(lo + 1, g - 1)
        return lo.long(), hi.long(), (s - lo).to(feat_map.dtype)

    y0, y1, wy = src(r)
    x0, x1, wx = src(c)

    def take(yy, xx):
        return gather_points(flat, yy * g + xx)

    wy = wy[..., None]
    wx = wx[..., None]
    top = take(y0, x0) * (1 - wx) + take(y0, x1) * wx
    bot = take(y1, x0) * (1 - wx) + take(y1, x1) * wx
    return top * (1 - wy) + bot * wy


class ConvTranspose2x2(nn.ConvTranspose2d):
    """flax's ``nn.ConvTranspose(features, (2, 2), strides=(2, 2))`` on a
    channels-last map, computing in ``dtype``: output pixel (2i + a, 2j + b)
    is input pixel (i, j) times tap (a, b) of the torch weight (in, out, 2, 2),
    which is flax's (2, 2, in, out) kernel flipped in both spatial axes
    (``utils/convert.py``)."""

    def __init__(self, in_channels: int, out_channels: int, dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, 2, stride=2)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2).to(d), self.weight.to(d), self.bias.to(d), stride=2)
        return y.permute(0, 2, 3, 1)


class ViTAE(nn.Module):
    """ViT pyramid (4 taps concatenated) + upscaler to a (4g, 4g) map: one
    Dense to 4 x 4 patches (``up_type="linear"``), or two 2x2 stride-2
    transposed convolutions with a float32 LayerNorm and exact GELU between
    them (``"deconv"``). ``fused_attn`` and ``int8_gemm`` select the ViT's
    production mode (``models/vit.py``)."""

    def __init__(self, vit_type: str, up_type: str = "linear", embed_dim: int = 768, out_dim: int = 256,
                 use_pyramid_feat: bool = True, img_size: int = 224, dtype: torch.dtype = torch.float32,
                 fused_attn: bool = False, int8_gemm: bool = False):
        super().__init__()
        if up_type not in ("linear", "deconv"):
            raise ValueError(up_type)
        self.vit = make_vit(vit_type, img_size=img_size, dtype=dtype, fused_attn=fused_attn, int8_gemm=int8_gemm)
        self.up_type = up_type
        self.out_dim = out_dim
        self.use_pyramid_feat = use_pyramid_feat
        in_dim = self.vit.embed_dim * (4 if use_pyramid_feat else 1)
        if up_type == "linear":
            self.output_upscaling = Dense(in_dim, 16 * out_dim, dtype)
        else:
            self.deconv1 = ConvTranspose2x2(in_dim, 2 * out_dim, dtype)
            self.ln = LayerNorm(2 * out_dim, dtype)
            self.deconv2 = ConvTranspose2x2(2 * out_dim, out_dim, dtype)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """(B, H, W, 3) -> (B, 4g, 4g, out_dim) low-resolution feature map.
        In training the ViT is frozen: it runs its exact path without
        autograd (the JAX package cuts the gradient at its output), and only
        the upscaler is differentiated."""
        B = x.shape[0]
        with torch.set_grad_enabled(torch.is_grad_enabled() and not train):
            outs, _ = self.vit(x, train=train)
        npfx = self.vit.num_prefix_tokens
        outs = [o[:, npfx:, :] for o in outs]
        feat = torch.cat(outs, dim=2) if self.use_pyramid_feat else outs[-1]
        side = self.vit.grid
        if self.up_type == "deconv":
            g = self.deconv1(feat.reshape(B, side, side, feat.shape[-1]))
            return self.deconv2(F.gelu(self.ln(g)))
        up = self.output_upscaling(feat).reshape(B, side, side, 4, 4, self.out_dim)
        return up.permute(0, 1, 3, 2, 4, 5).reshape(B, side * 4, side * 4, self.out_dim)


class ViTEncoderOneRef(nn.Module):
    """Query + one-reference feature lifting."""

    def __init__(self, npoint: int = 2048, vit_type: str = "vit_base_patch14_reg4_dinov2", up_type: str = "linear",
                 embed_dim: int = 768, out_dim: int = 256, use_pyramid_feat: bool = True, img_size: int = 224,
                 dtype: torch.dtype = torch.float32, fused_attn: bool = False, int8_gemm: bool = False):
        super().__init__()
        self.npoint = npoint
        self.rgb_net = ViTAE(vit_type, up_type, embed_dim, out_dim, use_pyramid_feat, img_size, dtype, fused_attn,
                             int8_gemm)

    def get_img_feats(self, img: torch.Tensor, choose: torch.Tensor, train: bool = False) -> torch.Tensor:
        """Features (B, P, out_dim) of one crop's map at flat pixel indices."""
        return bilinear_gather(self.rgb_net(img, train), choose, img.shape[1])

    def encode_pair(self, rgb, rgb_choose, tem1_rgb, tem1_choose, train: bool = False):
        """Both crops through the backbone as one 2B batch."""
        B = rgb.shape[0]
        low = self.rgb_net(torch.cat([rgb, tem1_rgb], dim=0), train)
        return bilinear_gather(low[:B], rgb_choose, rgb.shape[1]), bilinear_gather(low[B:], tem1_choose, rgb.shape[1])

    def forward(self, rgb, rgb_choose, pts, tem1_rgb=None, tem1_choose=None, tem1_pts=None, dense_po=None,
                dense_fo=None, tem1_radius=None, train: bool = False):
        """Returns (dense_pm, dense_fm, dense_po, dense_fo, radius): both clouds
        divided by the reference radius, the reference FPS-subsampled to
        ``npoint`` points.

        With ``dense_po`` (in meters) and ``dense_fo`` (``UNOPose.
        encode_template``'s outputs) only the query crop runs the backbone,
        and the reference's subsample is divided by ``tem1_radius`` (the full
        cloud's radius), or by the subsample's own radius when it is None."""
        if dense_po is not None and dense_fo is not None:
            dense_fm = self.get_img_feats(rgb, rgb_choose, train)
            if tem1_radius is not None:
                radius = tem1_radius
            else:
                mean = dense_po.mean(dim=1, keepdim=True)
                radius = torch.linalg.vector_norm(dense_po - mean, dim=-1).amax(dim=-1)
            r = radius[:, None, None] + 1e-6
            return pts / r, dense_fm, dense_po / r, dense_fo, radius
        mean = tem1_pts.mean(dim=1, keepdim=True)
        radius = torch.linalg.vector_norm(tem1_pts - mean, dim=-1).amax(dim=-1)
        r = radius[:, None, None] + 1e-6
        dense_pm = pts / r
        tem1_pts = tem1_pts / r
        dense_fm, tem_feat = self.encode_pair(rgb, rgb_choose, tem1_rgb, tem1_choose, train)
        dense_po, dense_fo = sample_pts_feats(tem1_pts, tem_feat, self.npoint)
        return dense_pm, dense_fm, dense_po, dense_fo, radius
