"""Text encoders of the latent tiers in plain PyTorch.

Counterpart of ``diff_sampler_tpu/models/text.py``:

  * ``CLIPTextTransformer``: the ``openai/clip-vit-large-patch14`` text
    tower that Stable Diffusion v1.5 conditions on (the JAX package runs
    transformers' ``FlaxCLIPTextModel``), under transformers' state_dict
    names (``text_model.embeddings.token_embedding.weight``,
    ``text_model.encoder.layers.{i}.self_attn.q_proj.weight``, ...), so a
    checkpoint's ``cond_stage_model.transformer.*`` loads as it is.
    Pre-LayerNorm blocks, quick-GELU MLP, a causal mask and no padding
    mask; its attention over the 77 tokens is plain matmul and softmax, as
    in the JAX package, where no Pallas kernel serves T = 77.
  * ``FrozenCLIPEmbedder``: prompts -> [B, 77, 768] ``last_hidden_state``
    (``ldm/modules/encoders/modules.py:137-166``), through the in-repo BPE
    tokenizer (``utils/bpe.py``) padded with EOT, as CLIPTokenizer pads.
    The vocab file is found by ``utils.bpe.find_vocab_file``; where there is
    none, the first encode raises and names the places searched (the JAX
    package's ``CLIPTokenizer.from_pretrained`` fallback downloads, so the
    port has none).
  * ``BERTTextTransformer``: the LDM txt2img text encoder (x_transformer
    TransformerWrapper with a pre-norm Encoder, ``BERTEmbedder``), under the
    reference's names below ``cond_stage_model.transformer``.

Every layer takes ``reset_parameters(generator)``, so
``factory.init_params`` draws a tower from one seed.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .adm import _Linear
from .ldm import _LN, _LinearNoBias

__all__ = ["CLIPTextTransformer", "FrozenCLIPEmbedder", "BERTTextTransformer",
           "bert_params_from_state_dict"]

_CLIP_TEXT_CONFIG = dict(  # openai/clip-vit-large-patch14 text tower
    vocab_size=49408, hidden_size=768, intermediate_size=3072,
    num_hidden_layers=12, num_attention_heads=12, max_position_embeddings=77)


class _Embedding(nn.Module):
    def __init__(self, num: int, dim: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num, dim, device=device))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.weight.copy_(torch.randn(self.weight.shape, generator=generator) * 0.02)


def _attention(q, k, v, heads: int, mask: Optional[torch.Tensor]):
    """Multi-head attention of [B, T, heads * d] projections, f32 logits
    and softmax; ``mask`` is added to the logits."""
    b, t, inner = q.shape
    d = inner // heads
    q, k, v = (a.reshape(b, t, heads, d) for a in (q, k, v))
    logits = torch.einsum("bihd,bjhd->bhij", q.float() * d ** -0.5, k.float())
    if mask is not None:
        logits = logits + mask
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhij,bjhd->bihd", w, v).reshape(b, t, inner)


class _CLIPAttention(nn.Module):
    def __init__(self, dim: int, heads: int, device=None):
        super().__init__()
        self.heads = heads
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (
            _Linear(dim, dim, device=device) for _ in range(4))

    def forward(self, x, mask):
        return self.out_proj(_attention(self.q_proj(x), self.k_proj(x), self.v_proj(x),
                                        self.heads, mask))


class _CLIPMLP(nn.Module):
    def __init__(self, dim: int, inner: int, device=None):
        super().__init__()
        self.fc1 = _Linear(dim, inner, device=device)
        self.fc2 = _Linear(inner, dim, device=device)

    def forward(self, x):
        h = self.fc1(x)
        return self.fc2(h * torch.sigmoid(1.702 * h))  # quick_gelu


class _CLIPEncoderLayer(nn.Module):
    def __init__(self, dim: int, inner: int, heads: int, device=None):
        super().__init__()
        self.self_attn = _CLIPAttention(dim, heads, device=device)
        self.layer_norm1 = _LN(dim, device=device)
        self.mlp = _CLIPMLP(dim, inner, device=device)
        self.layer_norm2 = _LN(dim, device=device)

    def forward(self, x, mask):
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class CLIPTextTransformer(nn.Module):
    """The CLIP text tower: token + position embeddings, pre-LN encoder
    layers under a causal mask, the final LayerNorm.  ``forward(input_ids)``
    ([B, T] ints, T <= max_position_embeddings) returns the
    ``last_hidden_state`` [B, T, hidden_size] in f32."""

    def __init__(self, vocab_size: int = 49408, hidden_size: int = 768,
                 intermediate_size: int = 3072, num_hidden_layers: int = 12,
                 num_attention_heads: int = 12, max_position_embeddings: int = 77,
                 device=None):
        super().__init__()
        dev = dict(device=device)
        self.text_model = nn.Module()
        self.text_model.embeddings = nn.Module()
        self.text_model.embeddings.token_embedding = _Embedding(vocab_size, hidden_size, **dev)
        self.text_model.embeddings.position_embedding = _Embedding(
            max_position_embeddings, hidden_size, **dev)
        self.text_model.encoder = nn.Module()
        self.text_model.encoder.layers = nn.ModuleList([
            _CLIPEncoderLayer(hidden_size, intermediate_size, num_attention_heads, **dev)
            for _ in range(num_hidden_layers)])
        self.text_model.final_layer_norm = _LN(hidden_size, **dev)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        tm = self.text_model
        ids = input_ids.long()
        t = ids.shape[1]
        x = (tm.embeddings.token_embedding.weight[ids]
             + tm.embeddings.position_embedding.weight[:t])
        mask = torch.full((t, t), float("-inf"), device=x.device).triu(1)
        for layer in tm.encoder.layers:
            x = layer(x, mask)
        return tm.final_layer_norm(x)


class FrozenCLIPEmbedder(nn.Module):
    """prompts -> [B, 77, hidden] contexts (``last_hidden_state``), as the
    reference's FrozenCLIPEmbedder.encode; no gradients.  ``tokenizer``: a
    callable taking (prompts, truncation=True, max_length=77,
    padding="max_length", return_tensors="np") and returning
    {"input_ids": [B, 77]}, as transformers' CLIPTokenizer does; by default
    the in-repo BPE over the vocab file ``utils.bpe.find_vocab_file``
    finds, padded with EOT."""

    def __init__(self, tokenizer=None, device=None):
        super().__init__()
        self.transformer = CLIPTextTransformer(**_CLIP_TEXT_CONFIG, device=device)
        self.tokenizer = tokenizer

    def _get_tokenizer(self):
        if self.tokenizer is None:
            from ..utils.bpe import SimpleBPETokenizer

            # EOT padding, as CLIPTokenizer's pad token: the U-Net's
            # cross-attention reads all 77 hidden states, pads included
            tok = SimpleBPETokenizer.from_default_paths(context_length=77)
            tok.pad_id = tok.eot_id
            self.tokenizer = lambda prompts, **kw: {"input_ids": tok(list(prompts))}
        return self.tokenizer

    @torch.no_grad()
    def encode_ids(self, input_ids) -> torch.Tensor:
        """input_ids: [B, 77] ints (numpy or tensor) -> [B, 77, hidden] f32
        on the tower's device."""
        device = self.transformer.text_model.final_layer_norm.weight.device
        return self.transformer(torch.as_tensor(input_ids, device=device))

    def tokenize(self, prompts: Sequence[str]):
        """Prompts -> [B, 77] token ids (numpy), SOT ... EOT, truncated and
        padded to 77."""
        return self._get_tokenizer()(list(prompts), truncation=True, max_length=77,
                                     padding="max_length", return_tensors="np")["input_ids"]

    def forward(self, prompts: Sequence[str]) -> torch.Tensor:
        return self.encode_ids(self.tokenize(prompts))


class _BERTAttention(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, device=None):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.to_q, self.to_k, self.to_v = (_LinearNoBias(dim, inner, device=device)
                                           for _ in range(3))
        self.to_out = _Linear(inner, dim, device=device)

    def forward(self, x):
        return self.to_out(_attention(self.to_q(x), self.to_k(x), self.to_v(x), self.heads,
                                      None))


class _BERTFeedForward(nn.Module):
    """``net``: (Linear, GELU), Dropout, Linear, as x_transformer names them."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.net = nn.ModuleList([nn.ModuleList([_Linear(dim, 4 * dim, device=device)]),
                                  nn.Identity(), _Linear(4 * dim, dim, device=device)])

    def forward(self, x):
        return self.net[2](F.gelu(self.net[0][0](x)))


class BERTTextTransformer(nn.Module):
    """The LDM txt2img text encoder (``x_transformer.py:370-641``,
    ``BERTEmbedder``): token and absolute position embeddings, ``n_layer``
    pre-norm (LayerNorm, bidirectional attention) and (LayerNorm, GELU
    feed-forward) residual pairs as ``attn_layers.layers.{2i}`` /
    ``{2i + 1}``, the final ``norm``; ``forward(token_ids)`` returns the
    embeddings [B, T, n_embed]."""

    def __init__(self, n_embed: int = 1280, n_layer: int = 32, vocab_size: int = 30522,
                 max_seq_len: int = 77, heads: int = 8, dim_head: int = 64, device=None):
        super().__init__()
        dev = dict(device=device)
        self.token_emb = _Embedding(vocab_size, n_embed, **dev)
        self.pos_emb = nn.Module()
        self.pos_emb.emb = _Embedding(max_seq_len, n_embed, **dev)
        layers = []
        for _ in range(n_layer):
            layers.append(nn.ModuleList([_LN(n_embed, **dev),
                                         _BERTAttention(n_embed, heads, dim_head, **dev)]))
            layers.append(nn.ModuleList([_LN(n_embed, **dev), _BERTFeedForward(n_embed, **dev)]))
        self.attn_layers = nn.Module()
        self.attn_layers.layers = nn.ModuleList(layers)
        self.norm = _LN(n_embed, **dev)

    def forward(self, token_ids: torch.Tensor) -> torch.Tensor:
        ids = token_ids.long()
        x = self.token_emb.weight[ids] + self.pos_emb.emb.weight[:ids.shape[1]]
        for norm, block in self.attn_layers.layers:
            x = x + block(norm(x))
        return self.norm(x)


def bert_params_from_state_dict(state_dict: Dict[str, torch.Tensor],
                                depth: int) -> Dict[str, torch.Tensor]:
    """An LDM BERTEmbedder state_dict (``transformer.*``, the part below
    ``cond_stage_model.``) -> the state_dict of ``BERTTextTransformer`` at
    ``depth`` layers, in f32: the keys the JAX package's converter of the
    same name reads, and no other."""
    keys = ["token_emb.weight", "pos_emb.emb.weight", "norm.weight", "norm.bias"]
    for i in range(depth):
        a, f = f"attn_layers.layers.{2 * i}", f"attn_layers.layers.{2 * i + 1}"
        keys += [f"{a}.0.weight", f"{a}.0.bias", f"{a}.1.to_q.weight", f"{a}.1.to_k.weight",
                 f"{a}.1.to_v.weight", f"{a}.1.to_out.weight", f"{a}.1.to_out.bias",
                 f"{f}.0.weight", f"{f}.0.bias", f"{f}.1.net.0.0.weight", f"{f}.1.net.0.0.bias",
                 f"{f}.1.net.2.weight", f"{f}.1.net.2.bias"]
    return {k: torch.as_tensor(state_dict[f"transformer.{k}"]).float() for k in keys}
