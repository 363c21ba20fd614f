"""Replay pool of latent codes (counterpart of utils/latent_pool.py): a
history of generated W codes, so that a latent discriminator can train
against past encoder outputs. Host-side state, used outside the train
step; no shipped config wires it. Its draws come from an explicit
`torch.Generator` on the host."""

import torch


class LatentCodesPool:
    """Half the queries return (and replace) a stored code, the other half
    pass the fresh one through; until the pool is full, codes pass through
    and are stored."""

    def __init__(self, pool_size: int, seed: int = 0):
        self.pool_size = pool_size
        self.ws = []
        self.generator = torch.Generator().manual_seed(seed)

    def randint(self, n: int) -> int:
        return int(torch.randint(n, (), generator=self.generator))

    def uniform(self) -> float:
        return float(torch.rand((), generator=self.generator))

    def query(self, ws: torch.Tensor) -> torch.Tensor:
        """ws (B, 512) or (B, n_latent, 512), any device -> (B, 512) on the
        host: of a W+ code one random latent row is taken."""
        if self.pool_size == 0:
            return ws
        out = []
        for w in ws.detach().cpu():
            if w.ndim == 2:
                w = w[self.randint(len(w))]
            out.append(self._handle(w))
        return torch.stack(out)

    def _handle(self, w):
        if len(self.ws) < self.pool_size:
            self.ws.append(w)
            return w
        if self.uniform() > 0.5:
            i = self.randint(self.pool_size)
            old, self.ws[i] = self.ws[i], w
            return old
        return w
