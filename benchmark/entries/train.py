"""Training through ``train/loop.py::fit`` over a set resident on the card:
the chunked trainer, each step a replay of one captured CUDA graph, one
host wait a chunk of ``TRAIN_CHUNK_STEPS`` steps.

One ``fit`` call is the whole run: its object (the parameters, Adam's
state, the captured step) is built once.  Its first steps, on rows that all
differ, are set-up: the first runs eagerly and builds every lazy state, the
second is captured and replayed, the third replayed, and ``fit``'s
checkpointer interface hands the benchmark the parameters and Adam's state
after each (nothing is written to disk).  The window opens there and closes at the
first chunk drained after ``seconds``: ``train_images_per_s`` counts the
images of the steps whose metrics reached the host, over the window's wall
time.  The run then ends the call."""
from __future__ import annotations

import copy
from typing import Any, Dict, List

import torch

from .. import closed_loop, counts, faults
from . import widest
from ..profiling import LEAD_CALLS, Session as TraceSession, kept
from ..reference import train as ref_train
from ..reference.flagship import srgb_to_linear
from ..traffic import generate

# the steps before the window, each compared with the reference: the first
# eager, the second captured, then replays; the state is read after each
CHECKED_STEPS = 3
# the traffic keys this entry reads
TRAFFIC = ("batch", "images", "height", "width")
FAULTS = faults.planted(faults.training, "unchanged", "half", "answer",
                        "stale_count")
# a cell cut to a size a CPU test holds: the same code paths
CPU_SIZES = {"traffic": {"batch": 4, "images": 12, "height": 24,
                         "width": 32},
             "config": {}}


class WindowClosed(Exception):
    """Raised from fit's progress callback to end the run's fit call."""


class _Recorder:
    """fit's checkpointer interface, keeping in memory the parameters and
    Adam's state after each of the first CHECKED_STEPS steps."""

    def __init__(self, batch: int, on_last):
        self.due = tuple(batch * (s + 1) for s in range(CHECKED_STEPS))
        self.states = {}
        self._on_last = on_last

    def would_save(self, samples: int, prev: int = None) -> bool:
        return samples in self.due

    def maybe_save(self, samples: int, params, opt_state, prev: int = None,
                   finalize: bool = False) -> bool:
        if finalize or samples not in self.due:
            return False
        # copies: on the CPU the state's arrays share the live tensors
        self.states[samples] = (
            {n: {k: v.detach().clone() for k, v in p.items()}
             for n, p in params.items()}, copy.deepcopy(opt_state))
        if samples == self.due[-1]:
            self._on_last()
        return False


class Session:
    def __init__(self, config: Dict, traffic: Dict, seed: int,
                 device: torch.device):
        self.device, self.config, self.traffic = device, config, traffic
        n, h, w = traffic["images"], traffic["height"], traffic["width"]
        gen = torch.Generator(device).manual_seed(seed)
        self.params0 = generate.training_weights(gen)
        photos = generate.device_photos(gen, n, h, w)
        self.images = srgb_to_linear(photos / 255.0).permute(
            0, 2, 3, 1).contiguous()
        self.comps = generate.comparisons(gen, n, config["whdr"]
                                          ["comparisons"])
        self.losses: List[float] = []
        self.recorder = None

    def window(self, seconds: float, trace_calls: int = 0
               ) -> Dict[str, Any]:
        """The run's fit call: set-up steps, the window, then, with
        ``trace_calls``, that many chunks traced (one a traced call)."""
        from reflectance_filtering_tpu_torch.models.networks import (
            NetworkConfig)
        from reflectance_filtering_tpu_torch.train import loop

        bs = self.traffic["batch"]
        chunk = loop.TRAIN_CHUNK_STEPS
        got: Dict[str, Any] = {}
        trace = {"session": None, "marks": 0, "leads": list(LEAD_CALLS)}

        def opened():
            got["start"] = closed_loop.clock()

        def progress(step: int, samples: int, metrics: Dict) -> None:
            if step < CHECKED_STEPS:
                self.losses.append(float(metrics["loss_total"]))
                return
            k = step - CHECKED_STEPS
            if k % chunk:
                return
            # the first step of a drained chunk: the chunk has run
            now = closed_loop.clock()
            if "wall_s" not in got:
                if now - got["start"] < seconds:
                    return
                got["wall_s"] = now - got["start"]
                got["requests"] = k + chunk
                if not trace_calls:
                    raise WindowClosed
            if trace["session"] is None:
                trace["session"] = TraceSession()
                trace["session"].start()
                trace["marks"] = 0
            trace["session"].mark()
            trace["marks"] += 1
            # a traced call is the chunk between two markers
            if trace["marks"] == trace["leads"][0] + trace_calls + 1:
                calls = kept(trace["session"].stop(), trace_calls)
                trace["session"] = None
                trace["leads"].pop(0)
                if calls is not None or not trace["leads"]:
                    got["calls"] = calls
                    raise WindowClosed

        self.recorder = _Recorder(bs, opened)
        data = {"images": self.images.cpu().numpy(),
                "comparisons": self.comps.cpu().numpy()}
        steps = CHECKED_STEPS + chunk * 1_000_000
        try:
            loop.fit(NetworkConfig(), loop.LossConfig(), data, steps * bs,
                     bs, solver_type="ADAM", base_lr=self.config["train"]
                     ["lr"], random_seed=0, init_params=self.params0,
                     checkpointer=self.recorder, progress=progress,
                     device=self.device)
        except WindowClosed:
            closed_loop.sync(self.device)
        imgs = bs * got["requests"]
        got["metrics"] = {"train_images_per_s": imgs / got["wall_s"]}
        got["pixels"] = bs * self.traffic["height"] * self.traffic["width"]
        got["model_flops"] = counts.train_step_flops(got["pixels"])
        got["per_call"] = chunk
        return got

    def release(self) -> Dict[str, Any]:
        return {"inputs": {"params0": self.params0, "images": self.images,
                           "comps": self.comps},
                "outputs": {"losses": self.losses,
                            "states": [self.recorder.states.get(samples)
                                       for samples in self.recorder.due]}}


def _batches(traffic: Dict, inputs: Dict):
    bs = traffic["batch"]
    return [(inputs["images"][s * bs:(s + 1) * bs],
             inputs["comps"][s * bs:(s + 1) * bs])
            for s in range(CHECKED_STEPS)]


def _leaf_gaps(prog: Dict, ref: Dict, leaves) -> Dict:
    """Each leaf's gap between the program's and the reference's norm,
    against the reference's norm of that leaf or of the median leaf,
    whichever is larger."""
    norms = {key: float(ref[key[0]][key[1]].double().norm())
             for key in leaves}
    median = sorted(norms.values())[len(norms) // 2]
    return {(n, k): abs(float(prog[n][k].double().norm()) - norms[(n, k)])
            / max(norms[(n, k)], median) for n, k in leaves}


def _on(tree, device):
    """A nested dict of tensors or arrays as float32 tensors on
    ``device``."""
    if isinstance(tree, dict):
        return {k: _on(v, device) for k, v in tree.items()}
    return torch.as_tensor(tree, dtype=torch.float32, device=device)


def judge(config: Dict, traffic: Dict, inputs: Dict, outputs: Dict,
          device: torch.device) -> Dict[str, float]:
    """The first CHECKED_STEPS steps, step 1 eager and the rest replays of
    the captured step, each against one reference step from the program's
    parameters and Adam's moments before it (step 1: the seeded start, as
    both sides have it), with Adam's count the reference's own, the step's
    index.  Each step's whole state after it is compared, so that nothing
    the program carries from step to step goes unchecked: the step's loss,
    its change of each parameter leaf, Adam's moments and count after it,
    and step 1's gradient as Adam got it; a leaf's numbers by the worst
    leaf.  Leaves whose reference gradient is under a thousandth of the
    median leaf's move by round-off alone and are left out of the change.

    From the program's state, not from the reference's own: after one
    step the two sides' parameters differ in their last bits, and that
    flips a ReLU at some comparison pixel on a few seeds in twenty, which
    moves a later step's gradient by up to ~1e-3 of a leaf."""
    if len(outputs["losses"]) < CHECKED_STEPS or None in outputs["states"]:
        raise RuntimeError("the run did not reach step {}".format(
            CHECKED_STEPS))
    lr = config["train"]["lr"]
    params, state = inputs["params0"], {}
    loss_gaps, change_gaps, moment_gaps, count_gaps = [], [], [], []
    grad_gap = None
    for (images, comps), loss, (p_after, s_after) in zip(
            _batches(traffic, inputs), outputs["losses"], outputs["states"]):
        value, grad, r_after, r_state = ref_train.adam_step(
            params, state, images, comps, lr)
        p_after, s_after = _on(p_after, device), _on(s_after, device)
        leaves = [(n, k) for n in grad for k in grad[n]]
        gnorm = {key: float(grad[key[0]][key[1]].double().norm())
                 for key in leaves}
        gmedian = sorted(gnorm.values())[len(gnorm) // 2]
        moved = [key for key in leaves if gnorm[key] >= 1e-3 * gmedian]
        if grad_gap is None:
            beta1 = ref_train.BETAS[0]
            first = {n: {k: v / (1 - beta1) for k, v in p.items()}
                     for n, p in s_after["mu"].items()}
            grad_gap = widest(_leaf_gaps(first, grad, leaves).values())

        def change(after):
            return {n: {k: after[n][k] - params[n][k] for k in after[n]}
                    for n in after}

        loss_gaps.append(abs(loss - value) / abs(value))
        change_gaps.extend(_leaf_gaps(change(p_after), change(r_after),
                                      moved).values())
        for key in ("mu", "nu"):
            moment_gaps.extend(_leaf_gaps(s_after[key], r_state[key],
                                          leaves).values())
        count_gaps.append(abs(float(s_after["count"]) - r_state["count"]))
        params = p_after
        state = {"count": r_state["count"], "mu": s_after["mu"],
                 "nu": s_after["nu"]}
    return {"loss_gap": widest(loss_gaps), "grad_gap": grad_gap,
            "change_gap": widest(change_gaps),
            "moment_gap": widest(moment_gaps),
            "count_gap": widest(count_gaps)}


def control_outputs(config: Dict, traffic: Dict, inputs: Dict,
                    outputs: Dict, device: torch.device) -> Dict:
    """The reference one precision step lower (its products on TF32
    operands) in the program's place."""
    steps = ref_train.adam_steps(inputs["params0"], _batches(traffic, inputs),
                                 config["train"]["lr"], low=True)
    return {"losses": [value for value, _, _, _ in steps],
            "states": [(after, state) for _, _, after, state in steps]}
