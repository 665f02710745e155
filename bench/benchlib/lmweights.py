"""The weights of a language-model configuration, made from the run's
seed on the device: one group for the embedding, the final norm and the
head, then one group a layer. A group's bfloat16 leaves are one
``torch.randn`` call in the type they are served in, cut into views and
scaled in place; its float32 router is a second call. The program gets
these tensors as its parameters; the reference makes each group again,
alone, from the same seed, and takes nothing the program holds.

The scales (the configuration's ``init``) follow the usual fan-in rule,
with three choices of the benchmark's, each so that the comparison with
a float32 reference can hold:

* a routing code: dims [0, E) of each token's embedding are 0 except its
  own ``moe_topk`` of them, set to ``embed_code``, and each MoE layer's
  float32 router adds ``router_code`` at (perm[e], e) to noise of
  ``router_noise`` / sqrt(d), perm a permutation of that layer's. So a
  token picks its top-k experts with a wide margin, as a trained router
  does. Gaussian routers at 64 experts route on near-ties, which
  bfloat16 and float32 resolve differently for 4.9-40.9% of tokens, and
  then no comparison of logits can hold. The experts are not equally
  popular: a token's k code dims are drawn without replacement with
  weights exp(``expert_skew`` * z), z ~ N(0, 1) a dim, and each layer's
  permutation gives its experts another order of popularity. At 0.2 and
  8192 tokens the experts' loads vary by about a fifth of their mean and
  the fullest gets about 1.6 times it, so a capacity of 1.25 drops some
  assignments. A token's experts depend on its id alone, not on its
  context.
* ``out_gain`` on every output projection (attention's ``wo``, the
  MLPs', the shared and the routed experts'), so that the 28 layers'
  sum stays below the code in the residual stream.
* ``q_gain`` on ``wq``, so that attention over thousands of keys is not
  uniform and the attention's output matters.
"""
from __future__ import annotations

import dataclasses

from benchlib import stats

BF16_INITS = ("normal", "embed")


@dataclasses.dataclass(frozen=True)
class Leaf:
    name: str
    shape: tuple
    dtype: str  # "bfloat16" | "float32"
    init: str  # "normal" | "embed" | "router" | "ones"
    scale: float = 1.0


def layer_specs(cfg: dict) -> list:
    """(mixer, ffn) of every layer, in order."""
    return [(b["mixer"], b["ffn"]) for b in cfg["layers"] for _ in range(b["count"])]


def layout(cfg: dict) -> list:
    """The groups' leaves, named as the program's parameters."""
    d, H, KV = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"]
    dh = cfg.get("d_head") or d // H
    init, dt = cfg["init"], cfg["dtype"]
    out_gain = init["out_gain"]
    groups = [[
        Leaf("embed.table", (cfg["vocab"], d), dt, "embed"),
        Leaf("final_norm.scale", (d,), "float32", "ones"),
        Leaf("lm_head.w", (d, cfg["vocab"]), dt, "normal", d ** -0.5),
    ]]
    for i, (mixer, ffn) in enumerate(layer_specs(cfg)):
        if mixer != "attn":
            raise ValueError(f"layer {i}: no weights for the mixer {mixer!r}")
        p = f"layers.{i}."
        g = [Leaf(p + "ln1.scale", (d,), "float32", "ones"),
             Leaf(p + "mix.wq", (d, H * dh), dt, "normal", init["q_gain"] * d ** -0.5),
             Leaf(p + "mix.wk", (d, KV * dh), dt, "normal", d ** -0.5),
             Leaf(p + "mix.wv", (d, KV * dh), dt, "normal", d ** -0.5),
             Leaf(p + "mix.wo", (H * dh, d), dt, "normal", out_gain * (H * dh) ** -0.5),
             Leaf(p + "ln2.scale", (d,), "float32", "ones")]
        if ffn == "dense":
            f = cfg["d_ff"]
            g += [Leaf(p + "mlp.wi", (d, f), dt, "normal", d ** -0.5),
                  Leaf(p + "mlp.wg", (d, f), dt, "normal", d ** -0.5),
                  Leaf(p + "mlp.wo", (f, d), dt, "normal", out_gain * f ** -0.5)]
        elif ffn == "moe":
            E, de = cfg["n_experts"], cfg["d_expert"]
            g += [Leaf(p + "moe.router", (d, E), "float32", "router"),
                  Leaf(p + "moe.wi", (E, d, de), dt, "normal", d ** -0.5),
                  Leaf(p + "moe.wg", (E, d, de), dt, "normal", d ** -0.5),
                  Leaf(p + "moe.wo", (E, de, d), dt, "normal", out_gain * de ** -0.5)]
            if cfg["n_shared_experts"]:
                f = de * cfg["n_shared_experts"]
                g += [Leaf(p + "shared.wi", (d, f), dt, "normal", d ** -0.5),
                      Leaf(p + "shared.wg", (d, f), dt, "normal", d ** -0.5),
                      Leaf(p + "shared.wo", (f, d), dt, "normal", out_gain * f ** -0.5)]
        else:
            raise ValueError(f"layer {i}: no weights for the feed-forward {ffn!r}")
        groups.append(g)
    return groups


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def make_group(cfg: dict, seed: int, index: int, device) -> dict:
    """Group ``index``'s tensors, {name: tensor}, in the served types."""
    import torch

    leaves = layout(cfg)[index]
    gen = torch.Generator(device=device).manual_seed(stats.derive(seed, "weights", index))
    served = getattr(torch, cfg["dtype"])
    big = [l for l in leaves if l.init in BF16_INITS]
    flat = torch.randn(sum(_numel(l.shape) for l in big), dtype=served, generator=gen,
                       device=device)
    out, at = {}, 0
    for leaf in big:
        n = _numel(leaf.shape)
        t = flat[at:at + n].view(leaf.shape)
        at += n
        if leaf.init == "embed":
            _routing_code(cfg, t, gen)
        elif leaf.scale != 1.0:
            t.mul_(leaf.scale)
        out[leaf.name] = t
    for leaf in leaves:
        if leaf.init == "ones":
            out[leaf.name] = torch.ones(leaf.shape, dtype=torch.float32, device=device)
        elif leaf.init == "router":
            out[leaf.name] = _router(cfg, leaf.shape, gen, device)
    return {leaf.name: out[leaf.name] for leaf in leaves}


def _routing_code(cfg: dict, table, gen) -> None:
    """Dims [0, E) of each row: 0, except the row's own top-k experts'."""
    import torch

    E, K = cfg["n_experts"], cfg["moe_topk"]
    if not E:
        return
    V, dev = table.shape[0], table.device
    log_weight = cfg["init"]["expert_skew"] * torch.randn(E, generator=gen, device=dev)
    u = torch.rand((V, E), generator=gen, device=dev)
    # the top k of log-weight plus Gumbel noise: k draws without replacement
    picks = (log_weight - torch.log(-torch.log(u.clamp_min(1e-12)))).topk(K, dim=1).indices
    table[:, :E] = 0
    table[:, :E].scatter_(1, picks, cfg["init"]["embed_code"])


def _router(cfg: dict, shape, gen, device):
    import torch

    d, E = shape
    init = cfg["init"]
    w = torch.randn(shape, dtype=torch.float32, generator=gen, device=device)
    w.mul_(init["router_noise"] * d ** -0.5)
    perm = torch.rand(E, generator=gen, device=device).argsort()
    w[perm, torch.arange(E, device=device)] += init["router_code"]
    return w


def n_groups(cfg: dict) -> int:
    return 1 + len(layer_specs(cfg))
