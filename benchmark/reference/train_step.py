"""The plain shallow GAN training step: the losses, Adam with the clip by
global norm, and the two-phase step (D on the detached pairs of a first
generator forward taken without gradients; G through the updated D on a
second forward with fresh draws).

The losses are the published ones for shallow mode: the PostNet's L1 to
the target mel, the weighted L1 of the denormalised x0 prediction to the
(detached) coarse mel, LSGAN on the JCU logits, and feature matching
weighted by `lambda_fm_shallow`.  Adam follows optax: the clip scales by
max / |g| only when |g| >= max; a parameter without a gradient takes a
zero one; eps outside the square root.
"""

import torch

from .acoustic import Generator
from .discriminator import JCUDiscriminator


def _jcu(c, u, target):
    return 0.5 * (torch.mean(torch.square(c - target)) + torch.mean(torch.square(u - target)))


def weighted_mel_l1(pred, target, mel_mask):
    maskf = mel_mask[..., None].to(pred.dtype)
    pred, target = pred * maskf, target * maskf
    w = (torch.sum(torch.abs(target), dim=-1, keepdim=True) != 0).expand(target.shape).to(pred.dtype)
    return torch.sum(torch.abs(pred - target) * w) / torch.clamp(torch.sum(w), min=1.0)


def feature_matching(real_c, real_u, fake_c, fake_u, n_layers):
    w = 4.0 / (n_layers + 1)
    loss = 0.0
    for j in range(len(fake_c) - 1):
        loss = loss + w * 0.5 * (torch.mean(torch.abs(real_c[j].detach() - fake_c[j]))
                                 + torch.mean(torch.abs(real_u[j].detach() - fake_u[j])))
    return loss


class Adam:
    """Clip by global norm, Adam, then - lr * update, over a fixed list of
    parameters."""

    def __init__(self, params, betas, clip, eps=1e-8):
        self.params = list(params)
        self.b1, self.b2 = betas
        self.clip, self.eps = clip, eps
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.last_grads = None

    @torch.no_grad()
    def step(self, lr):
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        scale = torch.clamp(norm / self.clip, min=1.0)
        grads = [g / scale for g in grads]
        self.last_grads = grads
        t = self.count + 1
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            nu.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            update = (mu / (1.0 - self.b1 ** t)) / (torch.sqrt(nu / (1.0 - self.b2 ** t))
                                                     + self.eps)
            p.add_(update, alpha=-float(lr))
        self.count = t


class TrainStep:
    """G, D, their optimizers and the step of shallow training.  `draw`
    gives the diffusion step t and the noises from the step's own
    generator; dropout draws from torch's default generator."""

    def __init__(self, cfg, stats, device, generator):
        self.cfg = cfg
        opt, loss = cfg["train"]["optimizer"], cfg["train"]["loss"]
        self.G = Generator(cfg, stats).to(device)
        self.D = JCUDiscriminator(cfg["n_mels"], cfg["denoiser"]["residual_channels"],
                                  cfg["discriminator"]).to(device)
        self.opt_g = Adam(self.G.parameters(), opt["betas"], opt["grad_clip_thresh"])
        self.opt_d = Adam(self.D.parameters(), opt["betas"], opt["grad_clip_thresh"])
        self.lr_g, self.lr_d = float(opt["init_lr_G"]), float(opt["init_lr_D"])
        self.lambda_fm = loss["lambda_fm_shallow"]
        dc = cfg["discriminator"]
        self.n_disc_layers = dc["n_layer"] + dc["n_cond_layer"]
        self.generator = generator
        self.timesteps = cfg["denoiser"]["shallow_timesteps"]

    def draw(self, kind, shape):
        device = self.generator.device
        if kind == "t":
            return torch.randint(0, self.timesteps, shape, generator=self.generator, device=device)
        return torch.randn(shape, generator=self.generator, device=device)

    def _pairs(self, out, detach):
        x_ts, prev, pred = out.x_ts, out.x_t_prevs, out.x_t_prev_preds
        if detach:
            x_ts, prev, pred = x_ts.detach(), prev.detach(), pred.detach()
        return self.D(x_ts, prev, out.t), self.D(x_ts, pred, out.t)

    def __call__(self, batch):
        """One step; returns the losses as floats."""
        self.G.train()
        self.D.train()
        with torch.no_grad():
            out1 = self.G.train_forward(batch, self.draw, update_stats=False)
        (rc, ru), (fc, fu) = self._pairs(out1, detach=True)
        D_loss = _jcu(rc[-1], ru[-1], 1.0) + _jcu(fc[-1], fu[-1], 0.0)
        for p in self.opt_d.params:
            p.grad = None
        D_loss.backward()
        self.opt_d.step(self.lr_d)

        out = self.G.train_forward(batch, self.draw)
        for p in self.D.parameters():
            p.requires_grad_(False)
        (rc, ru), (fc, fu) = self._pairs(out, detach=False)
        adv = _jcu(fc[-1], fu[-1], 1.0)
        diff = self.G.diffusion
        postnet = torch.mean(torch.abs(out.postnet_output - batch["mels"]))
        mel = weighted_mel_l1(diff.denorm(out.x0_pred), out.coarse_mel, out.mel_mask)
        fm = self.lambda_fm * feature_matching(rc, ru, fc, fu, self.n_disc_layers)
        G_loss = adv + (mel + postnet) + fm
        for p in self.opt_g.params:
            p.grad = None
        G_loss.backward()
        for p in self.D.parameters():
            p.requires_grad_(True)
        self.opt_g.step(self.lr_g)
        losses = {"D_loss": D_loss, "G_loss": G_loss, "adv_loss": adv, "mel_loss": mel,
                  "postnet_loss": postnet, "fm_loss": fm}
        return {k: float(v.detach()) for k, v in losses.items()}
