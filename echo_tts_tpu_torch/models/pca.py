"""PCA latent projection: 1024-d z_q <-> 80-d model latents, always fp32
(counterpart of echo_tts_tpu/models/pca.py)."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from echo_tts_tpu_torch.core.device import resolve_device


@dataclasses.dataclass(frozen=True)
class PCAState:
    components: torch.Tensor  # (80, 1024)
    mean: torch.Tensor        # (1024,)
    latent_scale: float

    @staticmethod
    def from_arrays(components, mean, latent_scale, device=None) -> "PCAState":
        """On `device` (default cuda; raises when CUDA is absent)."""
        dev = resolve_device(device)
        return PCAState(torch.as_tensor(np.asarray(components), dtype=torch.float32, device=dev),
                        torch.as_tensor(np.asarray(mean), dtype=torch.float32, device=dev),
                        float(latent_scale))

    @staticmethod
    def random(key_seed: int = 0, latent_dim: int = 1024, out_dim: int = 80,
               device=None) -> "PCAState":
        """The JAX package's random projection, drawn by the same numpy
        generator, so both packages get the same state from one seed:
        orthonormal rows when out_dim <= latent_dim, else plain gaussian.
        On `device` (default cuda), as `from_arrays`."""
        rng = np.random.default_rng(key_seed)
        if out_dim <= latent_dim:
            q, _ = np.linalg.qr(rng.standard_normal((latent_dim, latent_dim)))
            comp = q[:out_dim]
        else:
            comp = 0.3 * rng.standard_normal((out_dim, latent_dim))
        return PCAState.from_arrays(comp, rng.standard_normal(latent_dim) * 0.01, 1.0,
                                    device=device)


def project(pca: PCAState, z_q: torch.Tensor) -> torch.Tensor:
    """(B, 1024, T) channels-first z_q -> (B, T, 80) model latents."""
    z = z_q.float().transpose(1, 2)
    z = (z - pca.mean) @ pca.components.T
    return z * pca.latent_scale


def deproject(pca: PCAState, latents: torch.Tensor) -> torch.Tensor:
    """(B, T, 80) -> (B, 1024, T)."""
    z = (latents.float() / pca.latent_scale) @ pca.components + pca.mean
    return z.transpose(1, 2)
