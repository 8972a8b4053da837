"""Batched lock-step serving: a decode loop over the model's cache.

Counterpart of ``repro/distributed/serve.py``.  PyTorch runs eagerly, so
there is no compiled step to cache; the cache the JAX package donates to
each step is updated in place here.  On a mesh (a bound
``launch.mesh.ProcessMesh``, with the JAX ``Server``'s ``rules``) the
batch rows split over the data axes and every family runs tensor-parallel
over the model axis (``models/tp.py``): each rank decodes on its blocks of
the params and the cache (the ssm family's conv and SSD states, the
hybrid's ring too), the logits come whole over the vocabulary, and the
tokens come back whole on every rank.  The cache is
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
from .collectives import all_reduce
from .sharding import (DEFAULT_RULES, NamedSharding, check_model_axis,
                       logical_pspec, pool_axes, sharded_trace,
                       tree_shardings)


@dataclasses.dataclass
class ServeConfig:
    batch: int
    ctx_len: int
    temperature: float = 0.0     # 0 = greedy
    seed: int = 0


class Server:
    def __init__(self, cfg: ArchConfig, serve: ServeConfig, device="cuda", *,
                 mesh=None, rules=None):
        self.cfg, self.serve = cfg, serve
        self.device = resolve_device(device)
        self.mesh, self.rules = mesh, rules or DEFAULT_RULES
        if mesh is not None:
            check_model_axis(cfg, mesh, self.rules)
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
        toks = torch.as_tensor(np.asarray(prompts), dtype=torch.int64,
                               device=self.device)
        if n_steps <= 0:
            return np.zeros((toks.shape[0], 0), dtype=np.int32)
        if self.mesh is not None:
            toks = self.batch_sharding().local(toks)
        if cache is None:
            cache = M.init_cache(self.cfg, self.serve.batch,
                                 self.serve.ctx_len, device=self.device,
                                 shardings=self.cache_shardings())
        if generator is None:
            if self._gen is None:
                self._gen = torch.Generator(self.device).manual_seed(
                    self.serve.seed)
            generator = self._gen
        finite = torch.ones((), dtype=torch.bool, device=self.device)
        out = []
        step = M.decode_step
        if self.mesh is not None:
            step = sharded_trace(step, self.mesh, self.rules)
        for i in range(n_steps):
            logits, cache = step(self.cfg, params, cache, toks,
                                 start_pos + i, self.serve.ctx_len)
            finite &= torch.isfinite(logits).all()
            if self.serve.temperature > 0:
                probs = torch.softmax(
                    logits.float() / self.serve.temperature, dim=-1)
                toks = torch.multinomial(probs, 1, generator=generator)[:, 0]
            else:
                toks = torch.argmax(logits, dim=-1)
            out.append(toks)
        out = torch.stack(out, dim=1).to(torch.int32)
        if self.mesh is not None:
            # the model ranks hold the same logits; the data ranks their rows
            data = pool_axes(self.mesh, self.rules)
            if self.mesh.count(data) > 1:
                finite = all_reduce(finite.to(torch.int32), self.mesh.group(
                    data)) == self.mesh.count(data)
            out = self.batch_sharding().gather(out)
        self.logits_finite = bool(finite)
        return out.cpu().numpy()

    # ---- shardings (a mesh) ---------------------------------------------------
    def batch_sharding(self):
        """The layout of a (batch, ...) tensor: rows over the data axes."""
        return NamedSharding(self.mesh, logical_pspec(
            ("batch",), (self.serve.batch,), self.mesh, self.rules))

    def cache_shardings(self):
        """The cache's layout (None without a mesh)."""
        if self.mesh is None:
            return None
        return tree_shardings(M.cache_specs(
            self.cfg, self.serve.batch, self.serve.ctx_len), self.mesh,
            self.rules)

    def param_shardings(self):
        """The params' layout (None without a mesh): a rank holds
        ``NamedSharding.local`` of each whole leaf (``models.init_params``
        or ``models.convert.params_blocks`` with these shardings)."""
        if self.mesh is None:
            return None
        return tree_shardings(M.param_specs(self.cfg), self.mesh, self.rules)
