"""The decoder of the benchmark's configurations in plain PyTorch, fp32
with TF32 off: token embedding; per layer RMSNorm, q/k/v projections,
rotary embedding (half split), grouped-query attention (q head h reads kv
head h // (H / KV)) over the keys at or before each query within the
sliding window where there is one, the output projection and the
residual; RMSNorm and a SwiGLU MLP, or a softmax router over the experts
whose top_k are taken and renormalised and whose SwiGLU outputs are added
with those weights, every routed token computed (no capacity, no drop);
the final RMSNorm and the head.

It is given the benchmark's weights through ``leaf(name, layer)`` (a
fresh bf16 draw from the seed) and token ids, and computes whole
sequences layer by layer, the attention in blocks of queries and the MLP
in blocks of rows, so that it fits beside what the process still holds.

``precision="fp8"`` is the control: the same computation with every
matrix product's operands (activations, weights, and attention's q, k, v
and weights) rounded to float8 e4m3 under one scale a tensor, the
precision below the configuration's bf16. ``precision="bf16"`` rounds the
same operands to bf16 instead: a witness of what bf16 alone moves, with
no code of the program's."""
from __future__ import annotations

from typing import Callable, List, Tuple

import torch

E4M3_MAX = 448.0


def exact_fp32():
    """fp32 products in fp32: no TF32 in cuBLAS or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def q8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to e4m3 under one scale (its absolute max at 448), back in fp32."""
    scale = t.abs().amax().clamp_min(1e-30) / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def q16(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bf16, back in fp32."""
    return t.to(torch.bfloat16).float()


ROUND = {"fp32": None, "bf16": q16, "fp8": q8}


class Decoder:
    def __init__(self, sizes, leaf: Callable[..., torch.Tensor], *, precision: str = "fp32",
                 q_block: int = 512, row_block: int = 4096):
        self.s = sizes
        self.leaf = leaf
        self.round = ROUND[precision]
        self.q_block = q_block
        self.row_block = row_block

    def w(self, name: str, layer: int = 0) -> torch.Tensor:
        t = self.leaf(name, layer).float()
        return self.round(t) if self.round else t

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return (self.round(a) if self.round else a) @ b

    def rms(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + self.s["eps"]) * w

    def rope(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """x (S, heads, D) at positions pos (S,)."""
        D = x.shape[-1]
        half = D // 2
        freq = 1.0 / self.s["theta"] ** (torch.arange(half, device=x.device,
                                                      dtype=torch.float32) / half)
        ang = (pos.float()[:, None] * freq)[:, None, :]
        cos, sin = torch.cos(ang), torch.sin(ang)
        x1, x2 = x[..., :half], x[..., half:2 * half]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin, x[..., 2 * half:]], -1)

    def attention(self, q, k, v) -> torch.Tensor:
        """q (S,H,D), k/v (S,KV,D) -> (S,H,D), causal within the window."""
        S, H, D = q.shape
        KV = k.shape[1]
        G, W = H // KV, self.s["window"]
        if self.round:
            q, k, v = self.round(q), self.round(k), self.round(v)
        out = torch.empty_like(q)
        for a in range(0, S, self.q_block):
            b = min(a + self.q_block, S)
            lo = max(0, a - W + 1) if W else 0
            qi = q[a:b].view(b - a, KV, G, D).permute(1, 2, 0, 3)          # KV,G,n,D
            ki = k[lo:b].permute(1, 2, 0)                                   # KV,D,m
            vi = v[lo:b].permute(1, 0, 2)                                   # KV,m,D
            sc = (qi @ ki[:, None]) * D ** -0.5                             # KV,G,n,m
            i = torch.arange(a, b, device=q.device)[:, None]
            j = torch.arange(lo, b, device=q.device)[None, :]
            keep = (j <= i) & ((j > i - W) if W else True)
            p = torch.softmax(sc.masked_fill(~keep, float("-inf")), -1)
            if self.round:
                p = self.round(p)
            o = p @ vi[:, None]                                             # KV,G,n,D
            out[a:b] = o.permute(2, 0, 1, 3).reshape(b - a, H, D)
        return out

    def mlp(self, h: torch.Tensor, l: int) -> torch.Tensor:
        gate, up, down = (self.w(n, l) for n in ("w_gate", "w_up", "w_down"))
        out = torch.empty_like(h)
        for a in range(0, h.shape[0], self.row_block):
            x = h[a:a + self.row_block]
            out[a:a + self.row_block] = self.mm(
                torch.nn.functional.silu(self.mm(x, gate)) * self.mm(x, up), down)
        return out

    def moe(self, h: torch.Tensor, l: int) -> torch.Tensor:
        s = self.s
        probs = torch.softmax(self.mm(h, self.w("router", l)), -1)
        wts, idx = torch.topk(probs, s["top_k"], -1)
        wts = wts / wts.sum(-1, keepdim=True)
        out = torch.zeros_like(h)
        gate_all = self.leaf("we_gate", l)
        up_all = self.leaf("we_up", l)
        down_all = self.leaf("we_down", l)
        for e in range(s["E"]):
            rows, slot = (idx == e).nonzero(as_tuple=True)
            if not len(rows):
                continue
            gate, up, down = (t[e].float() for t in (gate_all, up_all, down_all))
            if self.round:
                gate, up, down = self.round(gate), self.round(up), self.round(down)
            x = h[rows]
            y = self.mm(torch.nn.functional.silu(self.mm(x, gate)) * self.mm(x, up), down)
            out.index_add_(0, rows, y * wts[rows, slot, None])
        return out

    @torch.no_grad()
    def hidden(self, seqs: List[Tuple[torch.Tensor, int]]) -> List[torch.Tensor]:
        """Each sequence ``tokens`` (S,) read from position 0, all of them
        layer by layer (each layer's weights drawn once): the final
        normed hidden states (S - first, d) at positions first..S-1."""
        s = self.s
        d, H, KV, D = s["d"], s["H"], s["KV"], s["D"]
        lens = [t.shape[0] for t, _ in seqs]
        cuts = [0]
        for n in lens:
            cuts.append(cuts[-1] + n)
        tokens = torch.cat([t for t, _ in seqs])
        pos = torch.cat([torch.arange(n, device=tokens.device) for n in lens])
        x = self.leaf("embed")[tokens].float()
        for l in range(s["L"]):
            h = self.rms(x, self.leaf("attn_norm", l).float())
            q = self.rope(self.mm(h, self.w("wq", l).reshape(d, -1)).view(-1, H, D), pos)
            k = self.rope(self.mm(h, self.w("wk", l).reshape(d, -1)).view(-1, KV, D), pos)
            v = self.mm(h, self.w("wv", l).reshape(d, -1)).view(-1, KV, D)
            o = torch.cat([self.attention(q[a:b], k[a:b], v[a:b])
                           for a, b in zip(cuts, cuts[1:])]).reshape(-1, H * D)
            del q, k, v
            x = x + self.mm(o, self.w("wo", l).reshape(H * D, d))
            h = self.rms(x, self.leaf("mlp_norm", l).float())
            x = x + (self.moe(h, l) if s["E"] else self.mlp(h, l))
        norm = self.leaf("final_norm").float()
        return [self.rms(x[a + first:b], norm) for (a, b), (_, first)
                in zip(zip(cuts, cuts[1:]), seqs)]

    def head(self) -> torch.Tensor:
        """The head's weights (d, V), as the products read them."""
        return self.w("embed").t() if self.s["tied"] else self.w("lm_head")

    def logits(self, tokens: torch.Tensor, first: int) -> torch.Tensor:
        """fp32 logits (S - first, V) at positions first..S-1 of ``tokens``."""
        return self.mm(self.hidden([(tokens, first)])[0], self.head())
