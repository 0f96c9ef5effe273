"""``convert.init_numpy_params`` draws the reference's own DVQ-AE weights.

For the ``image`` and ``speech`` kinds, at the full-width
``DVQAEConfig()``, a smoke size and the speech scenario's config, and for
seeds 0 and 1, every array equals ``init_dvqae(jax.random.PRNGKey(seed),
cfg)``'s bit for bit, flattened by path: the conv kernels through the
reference's key tree (``split`` of 3, of 4 + n_res (3 + n_res for the
speech decoder), the 2-D convs' extra split), the zero biases and the
N(0, 1) codebook.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core.dvqae import DVQAEConfig as JConfig, init_dvqae  # noqa: E402
from repro_torch.convert import init_numpy_params  # noqa: E402
from repro_torch.core.dvqae import DVQAEConfig  # noqa: E402

CONFIGS = {
    "image_full": dict(kind="image"),
    "image_smoke": dict(kind="image", in_channels=3, hidden=16, latent_dim=8,
                        codebook_size=16, n_res_blocks=1),
    "speech_scenario": dict(kind="speech", in_channels=16, n_groups=8,
                            n_slices=2),
    "speech_smoke": dict(kind="speech", in_channels=5, hidden=16,
                         latent_dim=8, codebook_size=16, n_res_blocks=3),
}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.mark.parametrize("seed", (0, 1))
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_conv_kinds_are_the_references_draw(name, seed):
    over = CONFIGS[name]
    want = _flat(init_dvqae(jax.random.PRNGKey(seed), JConfig(**over)))
    got = init_numpy_params(DVQAEConfig(**over), seed)
    assert sorted(got) == sorted(want)
    for key, arr in want.items():
        assert got[key].dtype == np.float32 and got[key].shape == arr.shape, \
            key
        assert got[key].tobytes() == arr.tobytes(), key
