"""``ElasticFleet`` against ``repro.distributed.elastic`` on
``make_tpu_catalog()``: the reference test's job (2.5e16 FLOPs, 256
devices), the initial plan (the port's cold tick fed the reference's
multistart starts, as ``tests/test_torch_controller.py`` feeds them), a
replan after 30% of the fleet fails, and the seven load scales of
``examples/autoscale_controller.py``; plans equal. ``reshard_params``
from a 2x2 to a 4x1 mesh on 4 gloo ranks: the full tensors unchanged, the
local shapes those of the new specs."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch_ranks as R  # noqa: E402

import repro.core.multistart as jms  # noqa: E402
import repro.distributed.elastic as jel  # noqa: E402
from repro.core.workloads import JobSpec as JJob  # noqa: E402

import repro_torch.core.multistart as tms  # noqa: E402
import repro_torch.distributed.elastic as tel  # noqa: E402
from repro_torch.core.workloads import JobSpec as TJob  # noqa: E402
from repro_torch.testing import spawn_world  # noqa: E402

JOB = dict(name="train-104b", hlo_flops=2.5e16, hlo_bytes=1e14,
           collective_bytes=5e12, bytes_per_device=8e9, devices=256,
           step_budget_s=1.0)
SCALES = (1.0, 1.3, 1.8, 1.4, 0.8, 0.6, 1.0)
RESHARD_ARCH = "mixtral-8x22b"       # an expert dim among the sharded ones


@pytest.fixture(scope="module")
def plans():
    """(label, port plan, reference plan) for every replan, in order."""
    starts = []
    make = jms.make_starts

    def capture(prob, n_starts, seed=0):
        out = make(prob, n_starts, seed)
        starts.append(np.array(out))
        return out

    mp = pytest.MonkeyPatch()
    mp.setattr(jms, "make_starts", capture)
    mp.setattr(tms, "make_starts",
               lambda prob, n_starts, seed=0, generator=None:
               torch.as_tensor(starts[-1]))
    jf = jel.ElasticFleet(JJob(**JOB), delta_max=64.0)
    tf = tel.ElasticFleet(TJob(**JOB), delta_max=64.0, device="cpu")
    # the reference first: its cold tick captures the starts
    want = jf.initial_plan()
    out = [("initial", tf.initial_plan(), want)]
    failed = np.ceil(jf.controller.x_current * 0.3)
    want = jf.replan_after_failure(failed)
    out.append(("failure", tf.replan_after_failure(failed), want))
    for s in SCALES:
        want = jf.replan_for_demand(s)
        out.append((f"x{s}", tf.replan_for_demand(s), want))
    mp.undo()
    return out


@pytest.mark.parametrize("i", range(2 + len(SCALES)))
def test_plan_equals_the_reference(plans, i):
    label, got, want = plans[i]
    np.testing.assert_array_equal(got.counts, want.counts, err_msg=label)
    assert got.total_chips == want.total_chips
    assert got.cost_per_hour == pytest.approx(want.cost_per_hour, rel=1e-6)
    assert got.mesh_shape == want.mesh_shape
    if label == "initial":
        assert got.total_chips >= 64
    if label == "failure":
        assert got.total_chips >= plans[0][1].total_chips * 0.6
        assert got.mesh_shape[1] == 16


@pytest.mark.parametrize("chips", [0, 1, 15, 16, 17, 256, 1000])
@pytest.mark.parametrize("mp", [1, 8, 16])
def test_mesh_from_chips_equals_the_reference(chips, mp):
    assert tel._mesh_from_chips(chips, mp) == jel._mesh_from_chips(chips, mp)


@pytest.fixture(scope="module")
def resharded(tmp_path_factory):
    out = tmp_path_factory.mktemp("reshard")
    spawn_world(R.reshard_ranks, 4, out, str(out), RESHARD_ARCH)
    return [torch.load(out / f"reshard_{r}.pt") for r in range(4)]


def test_reshard_keeps_the_full_tensors(resharded):
    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    from repro_torch.optim import adamw
    cfg = get_config(RESHARD_ARCH).reduced()
    full = init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    for rank in resharded:
        got = adamw.tree_leaves(rank["full"])
        want = adamw.tree_leaves(full)
        assert len(got) == len(want)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_reshard_gives_the_new_specs_local_shapes(resharded):
    sharded = 0
    for rank in resharded:
        for local, shape, spec, on_new in rank["local"]:
            assert on_new
            want = list(shape)
            for d, assignment in enumerate(spec):
                if assignment == "data":
                    want[d] //= 4
                    sharded += 1
                assert assignment in (None, "data", "model")
            assert list(local) == want
    assert sharded > 0


def test_constrain_redistributes_a_dtensor(resharded):
    """A replicated (V, D) table constrained to ("vocab", "embed") under
    2x2 base rules: vocab over "model", embed over "data"."""
    for rank in resharded:
        placements, local = rank["constrained"]
        assert placements == ("S(1)", "S(0)")
        assert local == (128, 32)
