"""Plan composers: two-scheduler switch, interleave and skip-steps.

The port's own copy of ``sonicdiffusionbayeslab_tpu/schedulers/plans.py``.
What the reference's experimental pipelines did with in-loop branching over
mutable scheduler objects is plan composition here: integer and float64
row math before the run, so the engine's loop is the same for every
composition.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

from sonicdiffusionbayeslab_torch.schedulers.ddim import ddim_transition_row
from sonicdiffusionbayeslab_torch.schedulers.dpm import dpm_rows, make_ladder, simulate_orders
from sonicdiffusionbayeslab_torch.schedulers.plan import SamplePlan, StepRow, stack_rows


def join_index(ts_second: np.ndarray, last_first: int, type_switch: str) -> int:
    """Where schedule 2 picks up after schedule 1 stops at ``last_first``:
    ``closest`` = argmin |t - last|; ``left_closest`` = last index with
    t >= last; ``right_closest`` = first index with t <= last."""
    ts = np.asarray(ts_second)
    if type_switch == "closest":
        return int(np.argmin(np.abs(ts - last_first)))
    if type_switch == "left_closest":
        idx = np.nonzero(ts - last_first >= 0)[0]
        if len(idx) == 0:
            return 0
        return int(idx[-1])
    if type_switch == "right_closest":
        idx = np.nonzero(ts - last_first <= 0)[0]
        if len(idx) == 0:
            return len(ts) - 1
        return int(idx[0])
    raise ValueError(f"unknown type_switch {type_switch!r}")


def _check_same_space(a, b, what: str) -> None:
    """Both schedulers must carry the sample in the same space (VP, sigma
    or flow): one space's carry is undefined input to another's rows."""
    sa, sb = getattr(a, "SPACE", "vp"), getattr(b, "SPACE", "vp")
    if sa != sb:
        raise ValueError(
            f"{what} cannot compose {a.NAME} ({sa}-space) with {b.NAME} "
            f"({sb}-space): the carried sample lives on different paths. "
            f"Compose within one family (e.g. flow<->flow, vp<->vp)."
        )


def two_scheduler_plan(
    first,
    second,
    num_inference_steps_first: int,
    num_inference_steps_second: int,
    num_step_switch: int,
    type_switch: str = "closest",
) -> SamplePlan:
    """Phase 1 on ``first`` for ``num_step_switch`` steps, then join to
    ``second``'s schedule.  As in the reference, schedule 2's timesteps are
    seeded from schedule 1's, so the join re-executes the boundary timestep
    with scheduler 2; scheduler 2's multistep warm-up starts from zero at
    the join while the one shared history ring carries phase 1's pushes."""
    _check_same_space(first, second, "two_scheduler_plan")
    ts1 = first.timesteps(num_inference_steps_first)
    k = int(num_step_switch)
    if not 1 <= k <= len(ts1):
        raise ValueError(f"num_step_switch {k} out of range for {len(ts1)} steps")
    ts2 = ts1.copy()  # seeded schedule (see docstring)
    j = join_index(ts2, float(ts1[k - 1]), type_switch)

    rows: List[StepRow] = []
    rows += first.transition_rows(
        ts1, num_inference_steps_first, executed=range(k), tag="phase1"
    )
    rows += second.transition_rows_from_schedule(ts2, start=j, tag="phase2")
    return stack_rows(
        rows,
        name=f"two_scheduler[{first.NAME}->{second.NAME}]"
        f"(n1={num_inference_steps_first},switch={k},{type_switch})",
    )


def interleave_plan(
    main,
    inter,
    num_inference_steps: int,
    interliving_steps: Sequence[int],
    mode: str = "ladder",
) -> SamplePlan:
    """Interleaved-scheduler plan: the main schedule is cut into windows of
    ``solver_order`` steps; in each window listed in ``interliving_steps``
    only the first step runs, on the inter scheduler, and the rest are
    deleted; both schedulers share the history ring.

    ``mode="ladder"``: each executed step moves along the executed ladder
    (its true noise levels).  ``mode="reference"``: the reference's index
    arithmetic exactly (see :func:`_interleave_plan_reference`)."""
    if mode == "reference":
        return _interleave_plan_reference(main, inter, num_inference_steps, interliving_steps)
    if mode != "ladder":
        raise ValueError(f"unknown interleave mode {mode!r} (ladder | reference)")
    _check_same_space(main, inter, "interleave_plan")
    order = getattr(main, "solver_order", 1)
    ts_main = main.timesteps(num_inference_steps)
    windows = set(int(w) for w in interliving_steps)

    # Flow timesteps are sigma*T floats; VP grids stay integral (the ladder
    # indexes alphas_cumprod by timestep).
    is_flow = getattr(main, "SPACE", "vp") == "flow"
    cast = float if is_flow else int

    entries = []  # (timestep, owner)
    for i, t in enumerate(cast(x) for x in ts_main):
        if i // order in windows:
            if i % order == 0:
                entries.append((t, "inter"))
        else:
            entries.append((t, "main"))
    if not entries:
        raise ValueError("interleave plan deleted every step")

    ts_exec = np.asarray(
        [t for t, _ in entries], dtype=np.float64 if is_flow else np.int64
    )
    owners = [o for _, o in entries]
    rows: List[StepRow] = [None] * len(entries)  # type: ignore[list-item]

    for owner, sched in (("main", main), ("inter", inter)):
        positions = [i for i, o in enumerate(owners) if o == owner]
        if not positions:
            continue
        sched_rows = sched.ladder_rows(ts_exec, positions, tag=owner)
        for pos, row in zip(positions, sched_rows):
            rows[pos] = row
    return stack_rows(
        rows,
        name=f"interleave[{main.NAME}+{inter.NAME}]"
        f"(n={num_inference_steps},windows={sorted(windows)})",
    )


def _interleave_plan_reference(
    main,
    inter,
    num_inference_steps: int,
    interliving_steps: Sequence[int],
) -> SamplePlan:
    """The reference's interleave index arithmetic, reproduced exactly.

    The reference runs only with a position-indexed DPM main, a
    timestep-indexed DDIM inter and a first executed step owned by main;
    every other combination crashes there (an uninitialised ``_step_index``
    in the cross-ring push), and raises here.  For the runnable one:

    * main advances consecutive ladder positions of its full schedule from
      the first executed index (deletions do not resynchronise it), while
      the UNet is conditioned on the actual timestep;
    * main's order warm-up counts only main steps, while the shared ring
      also receives the inter steps' outputs;
    * the inter DDIM step at timestep t moves to t - T // (n // order), the
      stride of the inter scheduler's own coarser schedule;
    * each inter step's ring entry is converted with main's current sigma
      and the post-step latents z' = ws * x + we * eps, which needs eta = 0.
    """
    order = int(getattr(main, "solver_order", 1))
    n = int(num_inference_steps)
    ts_main = main.timesteps(n)
    windows = set(int(w) for w in interliving_steps)

    entries = []  # (index in the full schedule, timestep, owner)
    for i, t in enumerate(int(x) for x in ts_main):
        if i // order in windows:
            if i % order == 0:
                entries.append((i, t, "inter"))
        else:
            entries.append((i, t, "main"))
    if not entries:
        raise ValueError("interleave plan deleted every step")

    if not hasattr(inter, "eta"):  # timestep-indexed DDIM inter required
        raise NotImplementedError(
            "interleave mode='reference' with a position-indexed inter "
            "scheduler: the reference itself crashes here (uninitialized "
            "_step_index in the cross-ring convert_model_output, "
            "src/models.py:1025-1053) — use mode='ladder', or a DDIM inter."
        )
    if not hasattr(main, "solver_order"):
        raise NotImplementedError(
            "interleave mode='reference' needs a DPM-family main scheduler "
            "(the reference calls scheduler_main.convert_model_output "
            "unconditionally, src/models.py:1025-1031)."
        )
    if entries[0][2] != "main":
        raise NotImplementedError(
            "interleave mode='reference' with window 0 interleaved: the "
            "reference crashes (scheduler_main._step_index is None at the "
            "first post-inter ring push, src/models.py:1025-1031)."
        )

    ladder = make_ladder(main.schedule, ts_main, main.final_sigmas_type)
    main_entries = [(k, e) for k, e in enumerate(entries) if e[2] == "main"]
    p0 = main_entries[0][1][0]  # exact hit in the full schedule
    positions = [p0 + j for j in range(len(main_entries))]
    orders = simulate_orders(
        positions, len(ts_main), order,
        lower_order_final=main.lower_order_final,
        euler_at_final=main.euler_at_final,
        final_sigmas_type=main.final_sigmas_type,
    )
    main_rows = dpm_rows(
        main.schedule, ladder, positions, orders=orders,
        unet_timesteps=[e[1] for _, e in main_entries], tag="main-ref",
        **main._kw(),
    )

    if float(getattr(inter, "eta", 0.0)) != 0.0:
        raise NotImplementedError(
            "interleave mode='reference' with eta > 0: the reference pushes "
            "the POST-step latents into main's ring (src/models.py:1025-1031), "
            "which would carry the ancestral noise — inexpressible as a "
            "linear coefficient row. Use eta=0 (the reference default) or "
            "mode='ladder'."
        )

    n_inter = max(n // order, 1)
    stride = main.config.num_train_timesteps // n_inter
    rows: List[StepRow] = [None] * len(entries)  # type: ignore[list-item]
    for (k, _), row in zip(main_entries, main_rows):
        rows[k] = row
    main_seen = 0
    pred = main.config.prediction_type
    is_pp = main.algorithm_type.endswith("++")
    for k, (_, t, owner) in enumerate(entries):
        if owner == "main":
            main_seen += 1
            continue
        prev_t = t - stride
        row = ddim_transition_row(
            inter.schedule, t, prev_t if prev_t >= 0 else -1,
            eta=inter.eta, prediction_type=inter.config.prediction_type,
            tag="inter-ref",
        )
        # Main's conversion at its current ladder position p0 + main_seen,
        # applied to the post-step latents z' = ws * x + we * eps.
        rp = p0 + main_seen
        a_r, s_r = float(ladder.alpha[rp]), float(ladder.sigma_t[rp])
        if pred == "epsilon":
            cmr = (1.0 / a_r, -s_r / a_r) if is_pp else (0.0, 1.0)
        elif pred == "v_prediction":
            cmr = (a_r, -s_r) if is_pp else (s_r, a_r)
        elif pred == "sample":
            cmr = (0.0, 1.0) if is_pp else (1.0 / s_r, -a_r / s_r)
        else:
            raise ValueError(f"unknown prediction_type {pred!r}")
        ws, we = float(row.w_sample), float(row.w_eps)
        rows[k] = dataclasses.replace(
            row,
            cm_sample=cmr[0] * ws,
            cm_eps=cmr[0] * we + cmr[1],
        )
    return stack_rows(
        rows,
        name=f"interleave-ref[{main.NAME}+{inter.NAME}]"
        f"(n={n},windows={sorted(windows)})",
        hist_depth=order,
    )


def skip_plan(scheduler, num_inference_steps: int, skip_steps: Sequence[int]) -> SamplePlan:
    """Skip-steps plan: the listed step indices never run.  Position-indexed
    schedulers (DPM) advance consecutive ladder positions from the first
    executed index while the UNet is conditioned on the original timesteps,
    so with skips the run ends short of sigma 0, as in the reference;
    timestep-indexed ones (DDIM) drop those transitions."""
    skip = set(int(s) for s in skip_steps)
    executed = [i for i in range(num_inference_steps) if i not in skip]
    if not executed:
        raise ValueError("skip plan executes no steps")
    rows = scheduler.skip_rows(num_inference_steps, executed, tag="skip")
    return stack_rows(
        rows,
        name=f"skip[{scheduler.NAME}](n={num_inference_steps},skip={sorted(skip)})",
    )
