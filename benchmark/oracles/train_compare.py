"""The training comparison shared by the configurations: the reference
follows the program's first steps from the same seeded weights, on the same
batches worked out again from the corpus (``reference/data.py``), with its
draws from a generator seeded as the program's, float32 with TF32 off, then
clipping by global norm and AdamW under the warm-up schedule as the
configuration states them. Three numbers are compared:

* ``loss_gap``: the largest relative gap of a step's total loss;
* ``grad_gap``: over the leaves, the largest gap between the norm of the
  program's first gradient as Adam holds it (its first moment after one
  step over 1 - beta1) and the reference's clipped first gradient, over the
  larger of the reference leaf's norm and the median leaf's;
* ``change_gap``: the same of the parameters' change over the steps
  (``change_median_gap``: the median leaf's, beside it).

Leaves whose reference first gradient is under a thousandth of the median
leaf's move under Adam by rounding alone and are left out of ``change_gap``
(the rule is on the reference's gradient, not on names).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import data


def reference_steps(hp, items: dict, weights: dict, device, make_model, loss, n_steps: int,
                    tf32: bool = False) -> dict:
    """The reference's losses, clipped first gradient and parameters after
    ``n_steps`` steps."""
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
    names = sorted(items)
    sizes = np.minimum([len(items[n]["mel"]) for n in names], hp["max_frames"])
    plan = data.epoch_batches(np.asarray(sizes), int(hp["seed"]), 0, hp["max_tokens"],
                              hp["max_sentences"])
    model = make_model().to(device).train()
    model.load_state_dict({k: v.to(device) for k, v in weights.items()})
    params = [p for p in model.parameters() if p.requires_grad]
    opt = torch.optim.AdamW(params, lr=0.0, betas=(hp["optimizer_adam_beta1"],
                                                   hp["optimizer_adam_beta2"]),
                            eps=1e-8, weight_decay=float(hp.get("weight_decay", 0) or 0.0))
    gen = torch.Generator(device=device).manual_seed(int(hp["seed"]))
    out = {"loss": [], "names": []}
    for k in range(n_steps):
        raw = data.batch([items[n] for n in names], plan[k], hp, 0)
        out["names"].append([names[i] for i in plan[k]])
        b = {key: torch.as_tensor(v).to(device) for key, v in raw.items()}
        for key in ("txt_tokens", "mel2ph"):
            b[key] = b[key].long()
        opt.zero_grad(set_to_none=True)
        total, _ = loss(model, b, gen)
        total.backward()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        norm = torch.linalg.vector_norm(torch.stack([g.norm() for g in grads]))
        if hp.get("clip_grad_norm"):
            scale = torch.where(norm < hp["clip_grad_norm"], torch.ones_like(norm),
                                hp["clip_grad_norm"] / norm)
            for g in grads:
                g.mul_(scale)
        for group in opt.param_groups:
            group["lr"] = float(hp["lr"]) * min(k / max(int(hp["warmup_updates"]), 1), 1.0)
        if k == 0:
            out["grad"] = {n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()}
        opt.step()
        out["loss"].append(float(total.detach()))
    out["params"] = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}
    return out


def _leaf_gaps(prog: dict, ref: dict) -> dict:
    """{leaf: |norm of prog's - norm of ref's| / max(ref leaf's norm, the
    median leaf's)}; a leaf the program lacks reads inf."""
    norms = {n: float(v.double().norm()) for n, v in ref.items()}
    med = float(np.median(list(norms.values())))
    return {n: (abs(float(prog[n].double().norm()) - r) / max(r, med) if n in prog
                else float("inf")) for n, r in norms.items()}


def _worst(g: dict) -> tuple:
    n = max(g, key=g.get)
    return g[n], n


def gaps(recorded: dict, ref: dict, weights: dict) -> dict:
    loss = max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(recorded["loss"], ref["loss"]))
    grad, grad_at = _worst(_leaf_gaps(recorded["grad"], ref["grad"]))
    gnorm = {n: float(v.norm()) for n, v in ref["grad"].items()}
    med = float(np.median(list(gnorm.values())))
    keep = {n for n, v in gnorm.items() if v >= 1e-3 * med}
    dp = {n: recorded["params"][n] - weights[n] for n in keep}
    dr = {n: ref["params"][n] - weights[n] for n in keep}
    changes = _leaf_gaps(dp, dr)
    change, change_at = _worst(changes)
    return dict(loss_gap=loss, grad_gap=grad, change_gap=change,
                change_median_gap=float(np.median(list(changes.values()))),
                grad_at=grad_at, change_at=change_at, left_out=sorted(set(gnorm) - keep))


def compare_steps(run, hp, recorded, items, weights, limits, make_model, loss) -> None:
    n = len(recorded["loss"])
    ref = reference_steps(hp, items, weights, run.device, make_model, loss, n)
    if ref["names"] != recorded["names"]:
        recorded["mismatch"] = "the loader's first batches are not the reference's"
        for k in limits:
            run.compare(k, float("inf"), limits[k])
        return
    g = gaps(recorded, ref, weights)
    run.record["gaps"] = {k: v for k, v in g.items() if k.endswith("gap")}
    for k in limits:
        run.compare(k, g[k], limits[k])
    run.notes.append(f"reference followed {n} steps: losses {recorded['loss']} against "
                     f"{ref['loss']}; worst gradient leaf {g['grad_at']}, worst change leaf "
                     f"{g['change_at']}; left out of the change (reference gradient under "
                     f"1e-3 of the median leaf's): {g['left_out']}")


def control_gaps(run, hp, items, weights, make_model, loss, n_steps: int) -> dict:
    """The control: the reference in TF32 put in the program's place, against
    the reference in float32."""
    low = reference_steps(hp, items, weights, run.device, make_model, loss, n_steps, tf32=True)
    ref = reference_steps(hp, items, weights, run.device, make_model, loss, n_steps)
    return gaps(low, ref, weights)
