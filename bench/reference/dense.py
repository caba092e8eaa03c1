"""The reference of ``arch_type`` "dense": the decoder of the DiPaCo
paper's Table 4 in plain PyTorch: token embedding (tied with the
output), ``num_layers`` pre-norm blocks of RMSNorm -> causal multi-head
attention with rotary embeddings (the two halves of each head rotated)
-> residual, RMSNorm -> GELU (tanh) MLP -> residual, a final RMSNorm
and the logits.

``leaf_specs(m)`` is its weight layout (the port's ``init_lm`` keys and
shapes).  ``Model(params, m, precision)`` takes a flat {"a/b": tensor}
tree of f32 leaves.  ``precision="fp8"`` rounds both inputs of every
matrix product (projections, scores, the attention-weighted sum, the
logits), and of every product of their backward, to float8 e4m3 with
one scale a tensor: the control, one precision below the
configuration's bfloat16.
"""
from __future__ import annotations

import math

import torch

from bench.reference.model import FP8MatMul


def leaf_specs(m: dict) -> list:
    """(key path, shape, std) of every leaf of a dense decoder of the
    configuration ``m`` (``configs/<name>.json``'s ``model``); std 0
    means a norm scale of ones."""
    d, h, kh, hd = m["d_model"], m["num_heads"], m["num_kv_heads"], \
        m["head_dim"]
    f, v, r = m["d_ff"], m["vocab_size"], m["num_layers"]
    blk = ("blocks", "pos0")
    return [
        (("embed", "embedding"), (v, d), 0.02),
        (blk + ("norm1",), (r, d), 0.0),
        (blk + ("mixer", "wq"), (r, d, h, hd), 1 / math.sqrt(d)),
        (blk + ("mixer", "wk"), (r, d, kh, hd), 1 / math.sqrt(d)),
        (blk + ("mixer", "wv"), (r, d, kh, hd), 1 / math.sqrt(d)),
        (blk + ("mixer", "wo"), (r, h, hd, d), 1 / math.sqrt(h * hd)),
        (blk + ("norm2",), (r, d), 0.0),
        (blk + ("mlp", "w_up"), (r, d, f), 1 / math.sqrt(d)),
        (blk + ("mlp", "w_down"), (r, f, d), 1 / math.sqrt(f)),
        (("final_norm",), (d,), 0.0),
    ]


class Model:
    def __init__(self, params: dict, m: dict, precision: str = "f32"):
        self.p, self.m, self.fp8 = params, m, precision == "fp8"

    def mm(self, a, b):
        if self.fp8:
            return FP8MatMul.apply(a, b)
        return torch.matmul(a, b)

    def norm(self, x, scale):
        var = torch.mean(x * x, dim=-1, keepdim=True)
        return x * torch.rsqrt(var + self.m.get("norm_eps", 1e-6)) * scale

    def rope(self, x, theta: float):
        """x (B, S, H, D): rotate the halves of D by position."""
        s, d = x.shape[1], x.shape[-1]
        inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                           device=x.device) / d)
        ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
            * inv[None, :]
        cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
        x1, x2 = x[..., :d // 2], x[..., d // 2:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def attention(self, r: int, x):
        m, p = self.m, self.p
        b, s, d = x.shape
        h, kh, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
        pre = "blocks/pos0/mixer/"
        q = self.mm(x, p[pre + "wq"][r].reshape(d, h * hd)).reshape(b, s, h, hd)
        k = self.mm(x, p[pre + "wk"][r].reshape(d, kh * hd)).reshape(b, s, kh,
                                                                   hd)
        v = self.mm(x, p[pre + "wv"][r].reshape(d, kh * hd)).reshape(b, s, kh,
                                                                   hd)
        theta = m.get("rope_theta", 10000.0)
        q, k = self.rope(q, theta), self.rope(k, theta)
        g = h // kh
        q = q.permute(0, 2, 1, 3)                              # B H S D
        k = k.permute(0, 2, 3, 1).repeat_interleave(g, dim=1)  # B H D S
        v = v.permute(0, 2, 1, 3).repeat_interleave(g, dim=1)  # B H S D
        scores = self.mm(q, k) / math.sqrt(hd)
        causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
        scores = scores.masked_fill(~causal, float("-inf"))
        out = self.mm(torch.softmax(scores, dim=-1), v)        # B H S D
        out = out.permute(0, 2, 1, 3).reshape(b, s, h * hd)
        return self.mm(out, p[pre + "wo"][r].reshape(h * hd, d))

    def mlp(self, r: int, x):
        pre = "blocks/pos0/mlp/"
        u = self.mm(x, self.p[pre + "w_up"][r])
        gelu = 0.5 * u * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                           * (u + 0.044715 * u ** 3)))
        return self.mm(gelu, self.p[pre + "w_down"][r])

    def hidden(self, tokens):
        """tokens (B, S) -> the final-normed hidden states (B, S, d)."""
        p = self.p
        x = p["embed/embedding"][tokens.long()]
        for r in range(self.m["num_layers"]):
            x = x + self.attention(r, self.norm(x, p["blocks/pos0/norm1"][r]))
            x = x + self.mlp(r, self.norm(x, p["blocks/pos0/norm2"][r]))
        return self.norm(x, p["final_norm"])

    def logits(self, tokens):
        """tokens (B, S) -> logits (B, S, V) in f32."""
        return self.mm(self.hidden(tokens), self.p["embed/embedding"].T)

    def nll_sum(self, tokens, prefix_len: int):
        """Summed next-token NLL of ``tokens`` (B, S) over the targets at
        positions >= ``prefix_len`` - 1 (the routing prefix is not
        trained), and how many targets that is."""
        lg = self.logits(tokens[:, :-1])
        tgt = tokens[:, 1:].long()
        logp = torch.log_softmax(lg, dim=-1)
        ll = torch.gather(logp, -1, tgt[..., None])[..., 0]
        keep = (torch.arange(tgt.shape[1], device=tgt.device) + 1
                >= prefix_len)
        return -(ll[:, keep]).sum(), int(keep.sum()) * tgt.shape[0]

    def features(self, tokens, prefix_len: int, rows: int = 256):
        """Routing features: the mean final hidden state over the first
        ``prefix_len`` tokens of each row -> (N, d)."""
        out = []
        with torch.no_grad():
            for i in range(0, tokens.shape[0], rows):
                h = self.hidden(tokens[i:i + rows, :prefix_len])
                out.append(h.mean(dim=1))
        return torch.cat(out)
