"""The cluster GELU+GRN kernel's decomposition (``gelu_grn_cluster_forward``
in csrc/stage.cu), emulated in plain PyTorch on the CPU, against the JAX
package's Pallas GELU+GRN in interpret mode (lane-aligned shapes) and its
jnp reference (a ragged shape).

The emulation repeats the kernel's split: a row's C channels cut into k
chunks of C/k, block r of the cluster holding [P, r*C/k, (r+1)*C/k); inside
a block the single-read thread layout (``stage_cuda.single_read_groups``
position groups PG: group q sums g^2 over positions q + i*PG in i order, and
the groups are folded in group order); each block's partial sum of its gx;
every block then adding the k partials in rank order, as it reads them from
the other blocks' shared memory, so that all blocks hold the same mean bit
for bit; y from each block's own g and gx. k = 1 is the single-read kernel.

Tolerances: float32 at rtol 1e-5 / atol 1e-5 (the same f32 arithmetic,
summed in another order); bf16 outputs at rtol / atol 1e-2 (one bf16
rounding of values computed in f32; a last-bit f32 difference can flip
it), gx in f32 as for float32 inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meanflow_audio_codec_tpu.ops import stage_pallas as jstage
from meanflow_audio_codec_torch.ops import stage_cuda
from meanflow_audio_codec_torch.ops.stage_ref import _gelu_f32

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=1e-2, atol=1e-2)


def gelu_grn_cluster(x3: torch.Tensor, gamma: torch.Tensor,
                     beta: torch.Tensor, k: int):
    """(y, gx [N, C], the mean each of the k blocks computed [k, N]) by the
    cluster kernel's decomposition."""
    n, p, c = x3.shape
    ck = c // k
    groups = stage_cuda.single_read_groups(p, ck, 16 // x3.element_size())
    assert groups, "the chunk does not fit one block"
    g = _gelu_f32(x3.float())
    chunks = [slice(r * ck, (r + 1) * ck) for r in range(k)]
    gxs, partials = [], []
    for cols in chunks:
        acc = torch.zeros(n, groups, ck)
        for first in range(0, p, groups):  # positions first + q, q < groups
            rows = g[:, first:first + groups, cols]
            acc[:, :rows.shape[1]] += rows * rows
        total = acc[:, 0]
        for q in range(1, groups):
            total = total + acc[:, q]
        gx = torch.sqrt(total + 1e-12)
        gxs.append(gx)
        partials.append(gx.sum(dim=1))
    means = []
    for _ in range(k):  # each block reads the k partials in rank order
        total = partials[0]
        for j in range(1, k):
            total = total + partials[j]
        means.append(total / c + 1e-6)
    y = torch.cat([g[:, :, cols] * (gamma[cols] + (gx / m[:, None])[:, None])
                   + beta[cols]
                   for cols, gx, m in zip(chunks, gxs, means)], dim=2)
    return y.to(x3.dtype), torch.cat(gxs, dim=1), torch.stack(means)


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return ((2.0 * rng.standard_normal(shape)).astype(np.float32),
            (0.5 * rng.standard_normal(shape[-1])).astype(np.float32),
            (0.1 * rng.standard_normal(shape[-1])).astype(np.float32))


def _jax(x, gamma, beta, dtype, aligned):
    jx = jnp.asarray(x).astype(jnp.float32 if dtype == torch.float32
                               else jnp.bfloat16)
    if aligned:  # the Pallas kernel, as tests/test_stage_pallas.py runs it
        y, gx = jstage._gelu_grn_pallas(jx, jnp.asarray(gamma)[None],
                                        jnp.asarray(beta)[None],
                                        interpret=True)
    else:
        y, gx = jstage._gelu_grn_ref(jx, jnp.asarray(gamma),
                                     jnp.asarray(beta))
    return np.asarray(y, np.float32), np.asarray(gx, np.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,k,aligned", [
    ((8, 16, 256), 1, True),    # the single-read kernel
    ((8, 16, 256), 2, True),
    ((8, 16, 256), 4, True),
    ((4, 256, 512), 4, True),   # the plan's own k (long P)
    ((3, 9, 96), 2, False),     # ragged P, C not lane-aligned
    ((3, 9, 96), 4, False),
], ids=str)
def test_cluster_decomposition_matches_jax(shape, k, aligned, dtype):
    x, gamma, beta = _inputs(shape, seed=sum(shape) + k)
    x3 = torch.from_numpy(x).to(dtype)
    y, gx, means = gelu_grn_cluster(x3, torch.from_numpy(gamma),
                                    torch.from_numpy(beta), k)
    assert all(torch.equal(m, means[0]) for m in means), \
        "the blocks of a cluster disagree on mean_C gx"
    want_y, want_gx = _jax(x, gamma, beta, dtype, aligned)
    np.testing.assert_allclose(y.float().numpy(), want_y,
                               **(F32 if dtype == torch.float32 else BF16))
    np.testing.assert_allclose(gx.numpy(), want_gx, **F32)

