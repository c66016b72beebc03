"""Time sampling; counterpart of ``meanflow_audio_codec_tpu/ops/time_sampling.py``.

Draws come from an explicit ``torch.Generator`` (on the device the samples
go to). PyTorch's generator gives other numbers than ``jax.random`` from the
same seed; tests hand the JAX draws to the port instead.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


def logit_normal(shape, generator: torch.Generator | None = None,
                 mean: float = -0.4, std: float = 1.0,
                 dtype: torch.dtype = torch.float32,
                 device: torch.device | str | None = None) -> torch.Tensor:
    """sigmoid(N(mean, std)): mass concentrated near 0 and 1."""
    z = torch.randn(shape, generator=generator, dtype=dtype, device=device)
    return torch.sigmoid(z * std + mean)


def sample_tr(batch_size: int, generator: torch.Generator | None = None,
              dtype: torch.dtype = torch.float32,
              device: torch.device | str | None = None, mean: float = -0.4,
              std: float = 1.0, data_proportion: float = 0.5,
              full_interval_proportion: float = 0.0
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """An ordered (t, r) pair per row, each ``[B, 1]`` with r <= t.

    Deterministic prefix: the first ``int(B * data_proportion)`` rows get
    r := t (the flow-matching boundary); the next
    ``int(B * full_interval_proportion)`` rows get exactly (t, r) = (1, 0),
    the query a 1-NFE decode evaluates.
    """
    t = logit_normal((batch_size, 1), generator, mean, std, dtype, device)
    r = logit_normal((batch_size, 1), generator, mean, std, dtype, device)
    t, r = torch.maximum(t, r), torch.minimum(t, r)
    n_data = int(batch_size * data_proportion)
    r[:n_data] = t[:n_data]
    if full_interval_proportion:
        n_full = int(batch_size * full_interval_proportion)
        t[n_data:n_data + n_full] = 1.0
        r[n_data:n_data + n_full] = 0.0
    return t, r


@dataclass(frozen=True)
class UniformTimeSampling:
    """t ~ U[0, 1]."""

    def sample_time(self, batch_size: int, generator=None,
                    dtype=torch.float32, device=None) -> torch.Tensor:
        return torch.rand((batch_size, 1), generator=generator, dtype=dtype,
                          device=device)


@dataclass(frozen=True)
class LogitNormalTimeSampling:
    """t ~ sigmoid(N(mean, std))."""

    mean: float = -0.4
    std: float = 1.0

    def sample_time(self, batch_size: int, generator=None,
                    dtype=torch.float32, device=None) -> torch.Tensor:
        return logit_normal((batch_size, 1), generator, self.mean, self.std,
                            dtype, device)


@dataclass(frozen=True)
class MeanFlowTimeSampling:
    """Ordered (t, r) pairs for mean-flow objectives (see :func:`sample_tr`)."""

    mean: float = -0.4
    std: float = 1.0
    data_proportion: float = 0.5
    full_interval_proportion: float = 0.0

    def sample_time(self, batch_size: int, generator=None,
                    dtype=torch.float32, device=None) -> torch.Tensor:
        return logit_normal((batch_size, 1), generator, self.mean, self.std,
                            dtype, device)

    def sample_time_pair(self, batch_size: int, generator=None,
                         dtype=torch.float32, device=None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
        return sample_tr(batch_size, generator, dtype, device, self.mean,
                         self.std, self.data_proportion,
                         self.full_interval_proportion)


_TIME_SAMPLERS = {
    "uniform": UniformTimeSampling,
    "logit_normal": LogitNormalTimeSampling,
    "mean_flow": MeanFlowTimeSampling,
}


def create_time_sampling(name: str | None, **kwargs):
    """Build a time sampler by config name (None -> logit_normal)."""
    if name is None:
        name = "logit_normal"
    if name not in _TIME_SAMPLERS:
        raise ValueError(f"Unknown time sampling {name!r}; expected one of "
                         f"{sorted(_TIME_SAMPLERS)}")
    return _TIME_SAMPLERS[name](**kwargs)
