"""The plain reference against the port's plain path (``kernel_impl``
'auto' on CPU tensors takes the plain versions) at the reduced
configurations, float32 on both sides: the loss, every gradient, ā and b̄
of every preconditioned weight, and one optimizer step.

Tolerances: both sides are float32 and sum in different orders, so the
loss and each gradient, ā and b̄ agree to 1e-5 of their norm; one step's
parameter change to 1e-4 of its own norm (the clip's scalar and the
preconditioner's division amplify the rounding a little)."""
import pytest
import torch

from portbench_cpu import CELLS, small_cell

RTOL = 1e-5
STEP_RTOL = 1e-4


def _rel(got, want):
    return float(torch.linalg.vector_norm(got.float() - want.float())
                 / torch.clamp(torch.linalg.vector_norm(want.float()),
                               min=1e-30))


def _both(name):
    from portbench.harness import manifest
    from portbench.harness.program import Program
    from portbench.harness.weights import make_weights, token_batches
    cell = small_cell(name)
    ref_model = manifest.reference_model(cell.config)
    prog = Program(cell, ref_model, 'cpu')
    params = make_weights(ref_model.param_specs(cell.config), 5, 'cpu')
    batches = token_batches(cell.traffic, cell.config['vocab'], 5, 'cpu')
    return cell, ref_model, prog, params, batches


@pytest.mark.parametrize('name', CELLS[:2])
def test_loss_grads_and_stats(name):
    from portbench.reference.common import grads_and_stats
    from repro_torch.train.step import compute_grads_and_stats
    torch.manual_seed(0)
    cell, ref_model, prog, params, batches = _both(name)
    loss, grads, stats = compute_grads_and_stats(prog.model, params,
                                                 batches[0], prog.capture)
    r_loss, r_grads, r_a, r_b = grads_and_stats(ref_model, cell.config,
                                                params, batches[0], True)
    assert abs(float(loss) - float(r_loss)) <= RTOL * abs(float(r_loss))
    assert set(grads) == set(r_grads)
    for p in grads:
        assert _rel(grads[p], r_grads[p]) <= RTOL, p
    assert set(stats) == set(r_a) == set(r_b)
    for p, st in stats.items():
        assert _rel(st.a_mean, r_a[p]) <= RTOL, p
        assert _rel(st.b_mean, r_b[p]) <= RTOL, p


@pytest.mark.parametrize('name', CELLS)
def test_one_step(name):
    from portbench.harness import check, manifest
    from portbench.reference.common import grads_and_stats
    cell, ref_model, prog, params, batches = _both(name)
    state = prog.init_state(params, batches[0])
    new, _, _ = prog.train_step()(params, state, batches[0])
    opt = manifest.reference_optimizer(cell.traffic)
    ref = {p: v.clone() for p, v in params.items()}
    r_state = opt.init(ref, ref_model.precon_paths(cell.config))
    _, grads, a, b = grads_and_stats(ref_model, cell.config, ref,
                                     batches[0], opt.CAPTURE)
    opt.step(r_state, ref, grads, a, b, cell.traffic['options'])
    for p in params:
        change = ref[p] - params[p]
        if float(torch.linalg.vector_norm(change)) == 0.0:
            assert torch.equal(new[p], params[p]), p
            continue
        assert _rel(new[p] - params[p], change) <= STEP_RTOL, p
    assert check.STEPS == 3


@pytest.mark.parametrize('name', CELLS)
def test_check_numbers_of_a_sound_run(name):
    """The three numbers of the check on a sound float32 run read at
    rounding level."""
    from portbench.harness import check
    from portbench.harness.bench import Session
    cell = small_cell(name)
    sess = Session(cell, 11, 'cpu')
    got, batches = sess.readings, sess.batches[:check.STEPS]
    sess.close()
    numbers = check.compare(got, check.reference_readings(cell, 11, batches,
                                                          'cpu'))
    assert max(v for v, _ in numbers.values()) <= 10 * STEP_RTOL
