"""The serving planner's candidate surfaces of the port against the JAX
package's (``tests/test_torch_deploy_planner.py`` holds the planner).

* The exact candidates (``dense/float32``, ``mscarep/...``) built by each
  package's build function on the same weights give logits within 1e-4 (relative) of
  each other; the JAX package runs its lax path on the CPU, whose border fix
  the port follows at every map size.
* SegNeXt's agreement is per pixel: the port's ``argmax(dim=1)`` over NCHW
  logits and JAX's ``argmax(-1)`` over NHWC ones give the same share on the
  same candidate and probe batch.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from convnet_approximater_tpu import deploy_planner as jplanner  # noqa: E402
from convnet_approximater_tpu_torch import deploy_planner as planner  # noqa: E402
from tests.test_torch_deploy_planner import (LOGITS_RTOL, MSCAN, factories,  # noqa: E402
                                             images, jax_logits, port_logits, rel)

torch.set_num_threads(1)


@pytest.fixture
def flat_timers(monkeypatch):
    """The MSCA-rep candidates' FfnRep arbitration in both packages under a timer
    that reads the same for every structure: each keeps every site original,
    with no compile (``test_torch_arbitrated_apply.py`` holds the arbiter)."""
    import convnet_approximater_tpu.hooks.inference_time_hook as jhook

    import convnet_approximater_tpu_torch.hooks.inference_time_hook as hook

    monkeypatch.setattr(jhook, "time_forward", lambda *a, **k: (None, None, np.ones(2)))
    monkeypatch.setattr(hook, "forward_seconds", lambda *a, **k: 1.0)


def test_exact_candidates_match_jax_logits(flat_timers):
    """dense/float32 and mscarep/... built by each package's build function on the
    same MSCAN weights."""
    make, jmake = factories(dict(MSCAN, num_blocks=(1, 1)), seed=4)
    shape = (2, 32, 32, 3)
    x = images(shape, 5)
    calib = [torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)]
    builds = dict(planner.default_candidates(make(), dtype=torch.float32, input_shape=shape))
    jbuilds = dict(jplanner.default_candidates(jmake()[0], dtype=jnp.float32, input_shape=shape))
    for name in ("dense/float32", "mscarep/d1+fix+dconv0+arb-ffnrep"):
        model = builds[name](make(), torch.Generator().manual_seed(0), calib)
        jmodel, jv = jbuilds[name](*jmake(), jax.random.key(0), [jnp.asarray(x)])
        assert rel(port_logits(model, x), jax_logits(jmodel, jv, x)) < LOGITS_RTOL, name


def test_segnext_agreement_is_per_pixel_as_jax(flat_timers):
    make, jmake = factories(None, seed=2)
    shape = (2, 64, 64, 3)
    name = "mscarep/d1+fix+dconv0+arb-ffnrep"
    build = dict(planner.default_candidates(make(), dtype=torch.float32, input_shape=shape))[name]
    jbuild_ = dict(jplanner.default_candidates(jmake()[0], dtype=jnp.float32,
                                               input_shape=shape))[name]
    x = images(shape, 6)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    ref = make()
    jref, jvars = jmake()
    calib = [xt]
    model = build(make(), torch.Generator().manual_seed(0), calib)
    jmodel, jv = jbuild_(*jmake(), jax.random.key(0), [jnp.asarray(x)])
    top1 = planner._top1(ref, xt)
    assert top1.shape == (2, 8, 8)
    agree = planner._agreement(model, [xt], [top1])
    jtop1 = jnp.argmax(jref.apply(jvars["params"], jnp.asarray(x), state=jvars["state"],
                                  training=False)[0], axis=-1)
    assert np.array_equal(top1.numpy(), np.asarray(jtop1))
    jagree = jplanner._agreement(jmodel, jv, [jnp.asarray(x)], [jtop1], jnp.float32)
    assert abs(agree - jagree) <= 1 / top1.numel()
    assert 0.5 <= agree <= 1.0  # the rank-1 conv0 is the only lossy rewrite
