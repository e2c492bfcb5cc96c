"""ImageReward-v1.0 (BLIP ViT-L/16 + BERT encoder with cross-attention +
an MLP head) in PyTorch.

Counterpart of ``sonicdiffusionbayeslab_tpu/metrics/image_reward_model.py``:
the image goes through a pre-LN ViT; the prompt's tokens through a post-LN
BERT whose layers attend to themselves (padding masked) and then to the
vision tokens; the [CLS] output feeds a 768->1024->128->64->16->1 linear
stack (the published head has no activations); the score is z-normalised
with the published constants.  Module names are the published
checkpoint's (``blip.visual_encoder.*`` in timm's ViT naming,
``blip.text_encoder.bert.*`` in transformers' BERT naming,
``mlp.layers.{0,2,4,6,7}``), so ``ImageReward.pt`` loads by name
(``load_image_reward_weights``).

Attention: the ViT's self-attention and BERT's cross-attention are
unmasked, so ``ops.attention`` sends them to the fp32 attention kernel on
the card (``[B, 197, 16, 64]`` and 35 queries over 197 image tokens at
``[B, *, 12, 64]``); BERT's masked self-attention takes the plain path,
as the JAX package sends masked calls to XLA.
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sonicdiffusionbayeslab_torch.models.clip_vision import clip_pixels
from sonicdiffusionbayeslab_torch.ops.attention import dot_product_attention

# Published normalisation constants of ImageReward-v1.0.
REWARD_MEAN = 0.16717362830052426
REWARD_STD = 1.0333394966054072


@dataclasses.dataclass(frozen=True)
class BLIPConfig:
    # ViT-L/16 vision tower
    image_size: int = 224
    patch_size: int = 16
    vision_width: int = 1024
    vision_layers: int = 24
    vision_heads: int = 16
    # BERT-base text encoder with cross-attention
    vocab_size: int = 30524  # bert-base + BLIP's [DEC]/[ENC] tokens
    text_width: int = 768
    text_layers: int = 12
    text_heads: int = 12
    text_intermediate: int = 3072
    max_text_len: int = 35  # ImageReward's truncation length

    @classmethod
    def tiny(cls) -> "BLIPConfig":
        return cls(image_size=32, patch_size=8, vision_width=32, vision_layers=2,
                   vision_heads=2, vocab_size=1000, text_width=32, text_layers=2,
                   text_heads=2, text_intermediate=64)


class _ViTAttention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(width, 3 * width)
        self.proj = nn.Linear(width, width)

    def forward(self, x):
        B, N, C = x.shape
        q, k, v = self.qkv(x).view(B, N, 3, self.heads, C // self.heads).unbind(2)
        return self.proj(dot_product_attention(q, k, v).reshape(B, N, C))


class _Mlp(nn.Module):
    def __init__(self, width: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(width, hidden)
        self.fc2 = nn.Linear(hidden, width)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class ViTBlock(nn.Module):
    """Pre-LN block (eps 1e-6), fused qkv, exact GELU."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(width, eps=1e-6)
        self.attn = _ViTAttention(width, heads)
        self.norm2 = nn.LayerNorm(width, eps=1e-6)
        self.mlp = _Mlp(width, 4 * width)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class _PatchEmbed(nn.Module):
    def __init__(self, cfg: BLIPConfig):
        super().__init__()
        self.proj = nn.Conv2d(3, cfg.vision_width, cfg.patch_size, stride=cfg.patch_size)

    def forward(self, pixels):
        return self.proj(pixels).flatten(2).transpose(1, 2)


class BLIPVisionModel(nn.Module):
    """Normalised pixels [B, 3, S, S] -> vision tokens [B, 1 + patches, W]."""

    def __init__(self, cfg: BLIPConfig):
        super().__init__()
        n = (cfg.image_size // cfg.patch_size) ** 2 + 1
        self.patch_embed = _PatchEmbed(cfg)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.vision_width))
        self.pos_embed = nn.Parameter(torch.zeros(1, n, cfg.vision_width))
        self.blocks = nn.ModuleList(ViTBlock(cfg.vision_width, cfg.vision_heads)
                                    for _ in range(cfg.vision_layers))
        self.norm = nn.LayerNorm(cfg.vision_width, eps=1e-6)

    def forward(self, pixels):
        x = self.patch_embed(pixels)
        x = torch.cat([self.cls_token.expand(x.shape[0], 1, -1), x], 1)
        x = x + self.pos_embed[:, : x.shape[1]]
        for blk in self.blocks:
            x = blk(x)
        return self.norm(x)


class BertSelfAttention(nn.Module):
    """Queries from ``x``, keys and values from ``kv`` (``kv_width`` wide:
    the vision width for cross-attention)."""

    def __init__(self, width: int, heads: int, kv_width: Optional[int] = None):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(width, width)
        self.key = nn.Linear(kv_width or width, width)
        self.value = nn.Linear(kv_width or width, width)

    def forward(self, x, kv, mask=None):
        B, N, C = x.shape
        M = kv.shape[1]
        D = C // self.heads
        q = self.query(x).view(B, N, self.heads, D)
        k = self.key(kv).view(B, M, self.heads, D)
        v = self.value(kv).view(B, M, self.heads, D)
        return dot_product_attention(q, k, v, mask=mask).reshape(B, N, C)


class _DenseLN(nn.Module):
    """transformers' ``BertSelfOutput`` / ``BertOutput``: LN(x + dense(h))."""

    def __init__(self, cin: int, width: int):
        super().__init__()
        self.dense = nn.Linear(cin, width)
        self.LayerNorm = nn.LayerNorm(width, eps=1e-12)

    def forward(self, h, x):
        return self.LayerNorm(x + self.dense(h))


class _BertAttention(nn.Module):
    def __init__(self, width: int, heads: int, kv_width: Optional[int] = None):
        super().__init__()
        self.self = BertSelfAttention(width, heads, kv_width)
        self.output = _DenseLN(width, width)

    def forward(self, x, kv, mask=None):
        return self.output(self.self(x, kv, mask), x)


class _Intermediate(nn.Module):
    def __init__(self, width: int, hidden: int):
        super().__init__()
        self.dense = nn.Linear(width, hidden)

    def forward(self, x):
        return F.gelu(self.dense(x))


class BertLayer(nn.Module):
    """Post-LN (eps 1e-12): masked self-attention, cross-attention over the
    vision tokens, exact-GELU MLP."""

    def __init__(self, cfg: BLIPConfig):
        super().__init__()
        w = cfg.text_width
        self.attention = _BertAttention(w, cfg.text_heads)
        self.crossattention = _BertAttention(w, cfg.text_heads, cfg.vision_width)
        self.intermediate = _Intermediate(w, cfg.text_intermediate)
        self.output = _DenseLN(cfg.text_intermediate, w)

    def forward(self, x, vision, mask=None):
        x = self.attention(x, x, mask)
        if vision is not None:
            x = self.crossattention(x, vision)
        return self.output(self.intermediate(x), x)


class _BertEmbeddings(nn.Module):
    def __init__(self, cfg: BLIPConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.text_width)
        self.position_embeddings = nn.Embedding(512, cfg.text_width)
        self.LayerNorm = nn.LayerNorm(cfg.text_width, eps=1e-12)

    def forward(self, ids):
        return self.LayerNorm(self.word_embeddings(ids)
                              + self.position_embeddings.weight[: ids.shape[1]])


class _BertEncoder(nn.Module):
    def __init__(self, cfg: BLIPConfig):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(cfg) for _ in range(cfg.text_layers))


class BLIPTextEncoder(nn.Module):
    """Token ids [B, T] (+ padding mask [B, T]) and vision tokens ->
    hidden states [B, T, W]."""

    def __init__(self, cfg: BLIPConfig):
        super().__init__()
        self.embeddings = _BertEmbeddings(cfg)
        self.encoder = _BertEncoder(cfg)

    def forward(self, input_ids, vision, attn_mask=None):
        x = self.embeddings(input_ids)
        mask = None if attn_mask is None else attn_mask[:, None, None, :].bool()  # [B,1,1,T]
        for layer in self.encoder.layer:
            x = layer(x, vision, mask)
        return x


class RewardHead(nn.Module):
    """ImageReward's MLP: Linear/Dropout stacks with no activations (the
    published head comments its ReLUs out), ``layers.{0,2,4,6,7}``."""

    def __init__(self, width: int = 768):
        super().__init__()
        self.layers = nn.Sequential(nn.Linear(width, 1024), nn.Dropout(0.2),
                                    nn.Linear(1024, 128), nn.Dropout(0.2),
                                    nn.Linear(128, 64), nn.Dropout(0.1),
                                    nn.Linear(64, 16), nn.Linear(16, 1))

    def forward(self, x):
        return self.layers(x)


class _TextEncoder(nn.Module):
    def __init__(self, cfg: BLIPConfig):
        super().__init__()
        self.bert = BLIPTextEncoder(cfg)


class _BLIP(nn.Module):
    def __init__(self, cfg: BLIPConfig):
        super().__init__()
        self.visual_encoder = BLIPVisionModel(cfg)
        self.text_encoder = _TextEncoder(cfg)


class ImageRewardModel(nn.Module):
    def __init__(self, cfg: BLIPConfig):
        super().__init__()
        self.cfg = cfg
        self.blip = _BLIP(cfg)
        self.mlp = RewardHead(cfg.text_width)

    def forward(self, pixels, input_ids, attn_mask=None):
        """Normalised pixels [B, 3, S, S] -> raw reward per pair, [B]."""
        vis = self.blip.visual_encoder(pixels)
        txt = self.blip.text_encoder.bert(input_ids, vis, attn_mask)
        return self.mlp(txt[:, 0])[:, 0]


class ImageRewardScorer:
    """images [B, H, W, 3] in [0, 1] + prompts -> z-normalised rewards [B]
    (numpy).  Random-init (seeded) unless given the ImageReward checkpoint;
    ``device``: CUDA unless given."""

    def __init__(self, checkpoint: Optional[str] = None, tiny: bool = False,
                 vocab_path: Optional[str] = None, device=None):
        from sonicdiffusionbayeslab_torch.models.sampler import init_module
        from sonicdiffusionbayeslab_torch.utils.device import resolve_device

        self.cfg = BLIPConfig.tiny() if tiny else BLIPConfig()
        self.device = resolve_device(device)
        with torch.device(self.device):
            self.model = ImageRewardModel(self.cfg)
        self.model.requires_grad_(False).eval()
        if checkpoint:
            load_image_reward_weights(checkpoint, self.model)
        else:
            gen = torch.Generator(device=self.device).manual_seed(0)
            init_module(self.model, gen)
            with torch.no_grad():
                self.model.blip.visual_encoder.pos_embed.normal_(0.0, 0.02, generator=gen)
                self.model.blip.text_encoder.bert.embeddings.position_embeddings.weight.normal_(
                    0.0, 0.02, generator=gen)
        self.tokenizer = _BertTokenizer(vocab_path, self.cfg.vocab_size, self.cfg.max_text_len)

    @torch.inference_mode()
    def raw(self, images: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """Raw rewards of images [B, H, W, 3] in [0, 1] on the device: BLIP
        normalises with CLIP's mean and std, then resizes (the JAX scorer's
        order), as ``clip_pixels`` does."""
        return self.model(clip_pixels(images, self.cfg.image_size), ids, mask)

    def __call__(self, images: np.ndarray, prompts) -> np.ndarray:
        from sonicdiffusionbayeslab_torch.utils.device import full_fp32

        ids, mask = self.tokenizer(list(prompts))
        dev = self.device
        with full_fp32():
            raw = self.raw(torch.as_tensor(np.asarray(images, np.float32), device=dev),
                           torch.as_tensor(ids, dtype=torch.long, device=dev),
                           torch.as_tensor(mask, device=dev)).cpu().numpy()
        return (raw - REWARD_MEAN) / REWARD_STD


class _BertTokenizer:
    """WordPiece when a bert ``vocab.txt`` is given, an FNV-1a hash of each
    word otherwise: ids and masks [B, max_len] (int32), [CLS] ... [SEP]."""

    def __init__(self, vocab_path: Optional[str], vocab_size: int, max_len: int):
        self.max_len = max_len
        self.vocab = None
        if vocab_path:
            p = Path(vocab_path)
            if p.exists():
                self.vocab = {w: i for i, w in enumerate(p.read_text().splitlines())}
        self.vocab_size = vocab_size
        self.cls, self.sep, self.pad, self.unk = 101, 102, 0, 100

    def _wordpiece(self, word: str):
        if word in self.vocab:
            return [self.vocab[word]]
        pieces, start = [], 0
        while start < len(word):
            end = len(word)
            cur = None
            while end > start:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = self.vocab[sub]
                    break
                end -= 1
            if cur is None:
                return [self.vocab.get("[UNK]", self.unk)]
            pieces.append(cur)
            start = end
        return pieces

    def __call__(self, texts):
        B = len(texts)
        ids = np.zeros((B, self.max_len), np.int32)
        mask = np.zeros((B, self.max_len), np.int32)
        for b, t in enumerate(texts):
            words = re.findall(r"\w+|[^\w\s]", t.lower())
            toks = []
            for w in words:
                if self.vocab is not None:
                    toks.extend(self._wordpiece(w))
                else:
                    h = 2166136261
                    for ch in w.encode():
                        h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
                    toks.append(103 + h % (self.vocab_size - 200))
            toks = [self.cls] + toks[: self.max_len - 2] + [self.sep]
            ids[b, : len(toks)] = toks
            mask[b, : len(toks)] = 1
        return ids, mask


# The published checkpoint's families that the model reads; anything else
# in the file (BLIP's projections and other heads, transformers' position-id
# buffer) is dropped by name.
_READ = ("blip.visual_encoder.", "blip.text_encoder.bert.embeddings.word_embeddings.",
         "blip.text_encoder.bert.embeddings.position_embeddings.",
         "blip.text_encoder.bert.embeddings.LayerNorm.", "blip.text_encoder.bert.encoder.",
         "mlp.layers.")


def load_image_reward_weights(path: str | Path, model: ImageRewardModel) -> ImageRewardModel:
    """The ImageReward-v1.0 torch checkpoint (``ImageReward.pt``, a state
    dict or ``{"state_dict": ...}``) into ``model``, by name and strictly
    over the families it reads: a missing or misshapen tensor raises."""
    from sonicdiffusionbayeslab_torch.models.weights import _load_strict

    sd = torch.load(str(path), map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    sd = {k: v.float() for k, v in sd.items()}
    _load_strict(model, sd, lambda k: not k.startswith(_READ), str(path))
    return model
