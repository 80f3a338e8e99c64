"""The port's fault-tolerance copy against ``repro.distributed.
fault_tolerance``: ``simulate_step_times`` and every straggler policy's
plans equal for the same seeds, and the supervisor's restart loop around
the same injected failures giving equal ``restarts``, ``events`` and
shard counts, each package resuming from its own checkpoints."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.checkpoint.checkpoint as jckpt  # noqa: E402
import repro.distributed.fault_tolerance as jft  # noqa: E402

import repro_torch.checkpoint.checkpoint as tckpt  # noqa: E402
import repro_torch.distributed.fault_tolerance as tft  # noqa: E402

SEEDS = (0, 1, 7)
POLICIES = ("wait", "deadline", "backup")


@pytest.mark.parametrize("seed", SEEDS)
def test_simulated_step_times_equal(seed):
    a, b = np.random.default_rng(seed), np.random.default_rng(seed)
    for n, prob in ((16, 0.05), (64, 0.08), (3, 0.5)):
        np.testing.assert_array_equal(
            tft.simulate_step_times(a, n, straggle_prob=prob),
            jft.simulate_step_times(b, n, straggle_prob=prob))


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("seed", SEEDS)
def test_straggler_plans_equal(policy, seed):
    rng = np.random.default_rng(seed)
    mon_t = tft.StragglerMonitor(n_workers=16, policy=policy)
    mon_j = jft.StragglerMonitor(n_workers=16, policy=policy)
    for _ in range(50):
        times = jft.simulate_step_times(rng, 16, straggle_prob=0.08)
        mon_t.observe(times)
        mon_j.observe(times)
        pt, pj = mon_t.plan(times), mon_j.plan(times)
        np.testing.assert_array_equal(pt["included"], pj["included"])
        assert pt["renorm"] == pj["renorm"]
        assert pt["backups"] == pj["backups"]
        assert (mon_t.effective_step_time(times)
                == mon_j.effective_step_time(times))
    assert mon_t.backup_queue == mon_j.backup_queue
    assert len(mon_t.history) == len(mon_j.history) == 50


def test_deadline_drops_the_straggler_and_unknown_policy_raises():
    plan = tft.StragglerMonitor(16, "deadline").plan(
        np.array([1.0] * 15 + [50.0]))
    assert plan["included"].sum() == 15
    assert abs(plan["renorm"] - 16 / 15) < 1e-9
    for mod in (tft, jft):
        with pytest.raises(ValueError):
            mod.StragglerMonitor(4, "nope").plan(np.ones(4))


def _supervise(ft, ckpt, path, fail_at, total=60, every=20, max_restarts=10):
    """The reference test's train_fn: checkpoints every ``every`` steps,
    one failure at each step of ``fail_at`` (first pass only); the shard
    count halves at each restart."""
    state = {"w": np.zeros(4, np.float32)}
    failed, shards_seen = set(), []

    def train_fn(start_step, num_shards):
        shards_seen.append(num_shards)
        step = start_step
        while step < total:
            step += 1
            state["w"] += 1.0
            if step % every == 0:
                ckpt.save(str(path), step, state)
            if step in fail_at and step not in failed:
                failed.add(step)
                raise RuntimeError(f"host_down@{step}")
        return step

    sup = ft.TrainingSupervisor(ft.SupervisorConfig(
        max_restarts=max_restarts), str(path))
    final = sup.run(train_fn, total_steps=total, initial_shards=8,
                    replan_shards=lambda n: max(1, n // 2))
    return final, sup.restarts, [(e.step, e.kind, e.worker)
                                 for e in sup.events], shards_seen


@pytest.mark.parametrize("fail_at", [(33,), (5, 33, 47), (20, 21, 59)])
def test_supervisor_restart_loop_equal(tmp_path, fail_at):
    got = _supervise(tft, tckpt, tmp_path / "port", set(fail_at))
    want = _supervise(jft, jckpt, tmp_path / "ref", set(fail_at))
    assert got == want
    assert got[0] == 60 and got[1] == len(fail_at)


def test_supervisor_gives_up_after_max_restarts(tmp_path):
    for ft, ckpt, name in ((tft, tckpt, "port"), (jft, jckpt, "ref")):
        with pytest.raises(RuntimeError):
            _supervise(ft, ckpt, tmp_path / name, {3, 4, 5},
                       max_restarts=2)
