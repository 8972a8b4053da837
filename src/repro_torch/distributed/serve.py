"""Batched lock-step serving: a decode loop over the model's cache.

Counterpart of ``repro/distributed/serve.py`` on one device.  PyTorch runs
eagerly, so there is no compiled step to cache and no mesh; the cache the
JAX package donates to each step is updated in place here.  The cache is
whatever ``models.init_cache`` / ``prefill`` make for the family: ring k/v
caches with a positions buffer (dense, vlm, moe; audio adds the cross k/v
of its encoder memory, so it decodes from a prefilled cache), conv and
SSD states with none (ssm), or both (hybrid); the server reads none of
them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..device import resolve_device
from ..models import model as M


@dataclasses.dataclass
class ServeConfig:
    batch: int
    ctx_len: int
    temperature: float = 0.0     # 0 = greedy
    seed: int = 0


class Server:
    def __init__(self, cfg: ArchConfig, serve: ServeConfig, device="cuda"):
        self.cfg, self.serve = cfg, serve
        self.device = resolve_device(device)
        self._gen: Optional[torch.Generator] = None  # threaded across calls
        #: whether every logit of the last ``generate`` call was finite
        self.logits_finite: Optional[bool] = None

    def generate(self, params, prompts: np.ndarray, n_steps: int,
                 start_pos: int = 0, cache=None,
                 generator: Optional[torch.Generator] = None) -> np.ndarray:
        """prompts: (B,) current last tokens → (B, n_steps) int32 tokens.

        Greedy (``temperature == 0``, first maximal index on ties) or
        temperature sampling.  Pass a prefilled ``cache`` to continue from a
        prompt (it is updated in place); otherwise decoding starts from an
        empty cache.

        Sampling state: the server's generator is seeded lazily from
        ``serve.seed`` and THREADED across calls, so successive sampled
        calls draw fresh streams.  An explicit ``generator`` is used for
        this call only and the server's own is left untouched.  The streams
        are torch's, not JAX's.
        """
        if cache is None:
            cache = M.init_cache(self.cfg, self.serve.batch,
                                 self.serve.ctx_len, device=self.device)
        toks = torch.as_tensor(np.asarray(prompts), dtype=torch.int64,
                               device=self.device)
        if n_steps <= 0:
            return np.zeros((toks.shape[0], 0), dtype=np.int32)
        if generator is None:
            if self._gen is None:
                self._gen = torch.Generator(self.device).manual_seed(
                    self.serve.seed)
            generator = self._gen
        finite = torch.ones((), dtype=torch.bool, device=self.device)
        out = []
        for i in range(n_steps):
            logits, cache = M.decode_step(self.cfg, params, cache, toks,
                                          start_pos + i, self.serve.ctx_len)
            finite &= torch.isfinite(logits).all()
            if self.serve.temperature > 0:
                probs = torch.softmax(
                    logits.float() / self.serve.temperature, dim=-1)
                toks = torch.multinomial(probs, 1, generator=generator)[:, 0]
            else:
                toks = torch.argmax(logits, dim=-1)
            out.append(toks)
        self.logits_finite = bool(finite)
        return torch.stack(out, dim=1).to(torch.int32).cpu().numpy()
