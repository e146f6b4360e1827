"""Optimizers (`mixgantts_tpu/train/optim.py`), with optax's semantics.

- FS2 (aux mode): clip by global norm, Adam b = (0.9, 0.98), eps 1e-9,
  weight decay added to Adam's update (decoupled, times the schedule),
  then the Noam schedule on the optimizer's own update count, s = count + 1.
- GAN (naive and shallow, G and D): clip by global norm, Adam
  b = (0.5, 0.9), eps 1e-8, scaled by the per-epoch lr (`exponential_lr`).
- `grad_acc_step` = k: the mean of k gradients, applied once every k
  calls (optax.MultiSteps).

The clip scales by max/|g| only when |g| >= max, as `optax.clip_by_global_norm`
does (torch's `clip_grad_norm_` divides by |g| + 1e-6).  A parameter that
received no gradient takes a zero one, as in a JAX gradient tree: its
moments decay and weight decay still applies.
"""

import torch


def fs2_lr_schedule(d_model, warmup_steps, anneal_steps, anneal_rate):
    """Noam warm-up and decay with step annealing; lr scale d_model^-0.5.
    Returns schedule(count) -> lr, count = updates applied before this one."""
    init_lr = d_model ** -0.5

    def schedule(count):
        s = count + 1.0
        lr = min(s ** -0.5, s * warmup_steps ** -1.5)
        for a in anneal_steps:
            if s > a:
                lr *= anneal_rate
        return init_lr * lr

    return schedule


def exponential_lr(init_lr, gamma, epoch):
    """The GAN optimizers' per-epoch ExponentialLR value of a 1-based epoch
    (the JAX train loop multiplies by gamma at every epoch boundary)."""
    return init_lr * gamma ** (epoch - 1)


class Adam:
    """Clip -> Adam -> (+ weight_decay * param) -> * -lr over a fixed list
    of parameters, reading their `.grad`.  `schedule` (count -> lr) sets
    the lr when `step` is given none."""

    def __init__(self, params, betas, eps=1e-8, clip=None, weight_decay=0.0,
                 every_k=1, schedule=None):
        self.params = list(params)
        self.b1, self.b2 = betas
        self.eps, self.clip, self.weight_decay = eps, clip, weight_decay
        self.every_k = max(1, int(every_k))
        self.schedule = schedule
        self.count = 0       # updates applied (optax's inner count)
        self.mini_step = 0   # gradients accumulated toward the next update
        self.mu = self.nu = self.acc = None

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self, lr=None):
        """Take the gradients in; apply an update when k have come in.
        Returns whether it applied one."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        if self.every_k > 1:
            n = self.mini_step
            if self.acc is None:
                self.acc = [torch.zeros_like(p) for p in self.params]
            # running mean, as optax.MultiSteps: acc + (g - acc) / (n + 1)
            delta = torch._foreach_sub(grads, self.acc)
            torch._foreach_div_(delta, float(n + 1))
            torch._foreach_add_(self.acc, delta)
            self.mini_step = (n + 1) % self.every_k
            if self.mini_step:
                return False
            grads, self.acc = self.acc, None
        if self.clip is not None:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            grads = torch._foreach_div(grads, torch.clamp(norm / self.clip, min=1.0))
        if self.mu is None:
            self.mu = [torch.zeros_like(p) for p in self.params]
            self.nu = [torch.zeros_like(p) for p in self.params]
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - b2)
        t = self.count + 1
        denom = torch._foreach_div(self.nu, 1.0 - b2 ** t)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        update = torch._foreach_div(self.mu, 1.0 - b1 ** t)
        torch._foreach_div_(update, denom)
        if self.weight_decay:
            torch._foreach_add_(update, self.params, alpha=self.weight_decay)
        lr = self.schedule(self.count) if lr is None else lr
        torch._foreach_add_(self.params, update, alpha=-float(lr))
        self.count = t
        return True

    def state_dict(self, lr=None):
        """The state in `torch.optim.Adam.state_dict()`'s shape: per
        parameter index {step, exp_avg, exp_avg_sq} once an update has been
        applied, and one param group with `lr` (the schedule's next value
        when none is given).  For exact resume the group also holds optax's
        update count (`count`, the Noam schedule's input) and MultiSteps'
        gradient counter (`mini_step`), and each parameter's entry the
        running mean of the gradients still pending (`acc`)."""
        state = {}
        for i in range(len(self.params)):
            entry = {}
            if self.mu is not None:
                entry.update(step=torch.tensor(float(self.count)), exp_avg=self.mu[i],
                             exp_avg_sq=self.nu[i])
            if self.acc is not None:
                entry["acc"] = self.acc[i]
            if entry:
                state[i] = entry
        group = {"lr": float(self.schedule(self.count) if lr is None else lr),
                 "betas": (self.b1, self.b2), "eps": self.eps,
                 "weight_decay": self.weight_decay, "amsgrad": False, "maximize": False,
                 "foreach": None, "capturable": False, "differentiable": False,
                 "fused": None, "count": self.count, "mini_step": self.mini_step,
                 "params": list(range(len(self.params)))}
        return {"state": state, "param_groups": [group]}

    def load_state_dict(self, state_dict):
        """Take back what `state_dict` wrote, onto these parameters'
        devices and types."""
        (group,) = state_dict["param_groups"]
        if len(group["params"]) != len(self.params):
            raise ValueError(f"optimizer state of {len(group['params'])} parameters "
                             f"for {len(self.params)}")
        state = state_dict["state"]
        self.count, self.mini_step = int(group["count"]), int(group["mini_step"])

        def tensors(key):
            if key not in state.get(0, {}):
                return None
            return [state[i][key].to(p.device, p.dtype, copy=True)
                    for i, p in enumerate(self.params)]

        self.mu, self.nu, self.acc = tensors("exp_avg"), tensors("exp_avg_sq"), tensors("acc")


def build_fs2_optimizer(params, model_config, train_config):
    fs2 = train_config["optimizer_fs2"]
    return Adam(
        params, fs2["betas"], eps=fs2["eps"],
        clip=train_config["optimizer"]["grad_clip_thresh"],
        weight_decay=fs2.get("weight_decay", 0.0),
        every_k=train_config["optimizer"].get("grad_acc_step", 1),
        schedule=fs2_lr_schedule(model_config["transformer"]["encoder_hidden"],
                                 fs2["warm_up_step"], fs2["anneal_steps"], fs2["anneal_rate"]))


def build_gan_optimizer(params, betas, clip, grad_acc_step=1):
    """Adam without a learning rate of its own: the step passes the
    per-epoch lr (`TrainState.lr_g`, `lr_d`)."""
    return Adam(params, betas, clip=clip, every_k=grad_acc_step)
