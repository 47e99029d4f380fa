"""The port's tiled PSF MLP (`ops/mlp_psf.py`) against the JAX package's
Pallas kernel `mlp_psf_pallas`, run in interpret mode on the CPU as
tests/test_pallas.py:10-22,126-138 runs it.

On the CPU the wrapper runs its plain version, the port's MLP forward; the
CUDA kernel is held to that plain version on the card by chip_smoke.py.
Tolerances are test_pallas.py's: 2e-5 against the JAX kernel (f32 sums in
another order) and rows summing to 1 within 1e-5.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.serialization import msgpack_restore

from aadff_tpu.ops.pallas_mlp import flax_mlp_weights, mlp_psf_pallas
from aadff_tpu.psfnet import MLP as JaxMLP
from aadff_tpu_torch.ops import mlp_psf
from aadff_tpu_torch.psfnet.arch import MLP
from aadff_tpu_torch.psfnet.convert import flax_mlp_to_torch_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PSFNET_CKPT = os.path.join(REPO, "ckpt", "rf50mm", "psfnet_480x640_ks11.msgpack")


def _field(n, seed):
    return np.random.default_rng(seed).uniform(-1, 1, (n, 4)).astype(np.float32)


def _port_mlp(variables):
    mlp = MLP()
    mlp.load_state_dict(flax_mlp_to_torch_state(variables))
    return mlp.requires_grad_(False)


@pytest.fixture(scope="module")
def random_variables():
    model = JaxMLP(in_features=4, out_features=121, hidden_features=256,
                   hidden_layers=8)
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 4)))
    return jax.tree.map(np.asarray, variables)


@pytest.fixture(scope="module")
def checkpoint_variables():
    with open(PSFNET_CKPT, "rb") as f:
        return msgpack_restore(f.read())


def _compare(variables, field):
    ref = np.asarray(mlp_psf_pallas(jnp.asarray(field),
                                    flax_mlp_weights(variables), 121,
                                    interpret=True, tile=1024))
    ours = mlp_psf.mlp_psf(_port_mlp(variables), torch.from_numpy(field))
    assert ours.shape == ref.shape == (field.shape[0], 121)
    np.testing.assert_allclose(ours.numpy(), ref, atol=2e-5)
    np.testing.assert_allclose(ours.sum(-1).numpy(), 1.0, atol=1e-5)


def test_random_weights_match_pallas_mlp(random_variables):
    """Random-init weights carried across, N = 2048 (two 1024-row tiles)."""
    _compare(random_variables, _field(2048, 0))


def test_checkpoint_weights_match_pallas_mlp(checkpoint_variables):
    """The converted psfnet_480x640_ks11 weights on the same field."""
    _compare(checkpoint_variables, _field(2048, 0))


def test_ragged_rows_match_pallas_mlp(random_variables):
    """N = 1500: the JAX kernel pads to its tile and slices back; the
    port's kernel masks the ragged end."""
    _compare(random_variables, _field(1500, 1))


def test_cpu_tensors_take_the_plain_version(random_variables):
    """A CPU tensor runs mlp_psf_reference and launches nothing."""
    mlp = _port_mlp(random_variables)
    field = torch.from_numpy(_field(77, 2))
    before = mlp_psf.launches
    out = mlp_psf.mlp_psf(mlp, field)
    assert mlp_psf.launches == before
    torch.testing.assert_close(out, mlp_psf.mlp_psf_reference(mlp, field),
                               rtol=0, atol=0)


def test_other_devices_are_refused(random_variables):
    field = torch.empty(8, 4, device="meta")
    with pytest.raises(ValueError, match="no PSF MLP kernel"):
        mlp_psf.mlp_psf(_port_mlp(random_variables), field)
