"""The model's pipeline stage on one rank (the training engine's pipelined
step, ``runtime/engine.py``; the JAX engine's ``engine.py:710-800``).

A :class:`ModelStage` is the :class:`~.schedule.PipeStage` of a model with
the streaming protocol (``models/transformer.py``): stage 0 embeds its
microbatch (``stream_embed``), every stage runs its layers
(``pipeline_stage``: each layer's dropout key folded from the micro-step's
key and its global index), the last runs the final norm, the head and the
cross entropy (``stream_tail_loss``) over the global valid-token count, the
moment the microbatch's forward ends. The attention mask is never sent:
every rank of a pipe group holds the whole microbatch and reads its own
copy. An MoE stage's aux loss, times ``moe_aux_loss_coef / M`` (and the
rank's data-parallel share), is a side term of that stage's backward; its
gradient reaches the earlier stages through the activation gradient sent
back. Each side term is seeded with the engine's ``loss_scale * gas`` (the
engine unscales by it), so the gradients of every microbatch sum to those
of the step's loss.

The stage's tensors come from a source: :class:`LeafSource` (ZeRO stages
0-2: the step's compute-dtype tensors, cast from the fp32 master and at
stages 1-2 gathered whole over the data axes once a step, as leaves whose
gradients the stage takes) or :class:`GatherSource` (stage 3: the stage's
blocks through ``zero/stage3.py``'s :class:`BlockGatherer`, gathered before
each block, re-gathered in its backward, the gradients reduced to the
master shards in the backward).
"""

from contextlib import nullcontext

import torch

from .schedule import PipeStage


def stage_blocks(model, layers, first, last):
    """{block name: state-dict keys} of a stage, in forward order: the
    embed block on stage 0, one block a layer, the tail on the last stage
    (a tied embedding sits in both the embed and the tail block)."""
    plan = model.stream_plan()
    blocks = {"embed": list(plan["embed"])} if first else {}
    for i in layers:
        blocks[f"layer{i}"] = [f"layers.{i}.{k}" for k in plan["layer"]]
    if last:
        blocks["tail"] = list(plan["tail"])
    return blocks


class LeafSource:
    """The step's compute tensors (``{key: leaf}``) by block."""

    def __init__(self, tensors, keys):
        self.tensors, self.keys = tensors, keys

    def open(self):
        return nullcontext()

    def persistent(self):
        return {}

    def block(self, name, keys):
        return {k: self.tensors[k] for k in keys}

    def done(self, name):
        pass

    def targets(self):
        return [self.tensors[k] for k in self.keys]


class GatherSource:
    """Stage 3: each block gathered by ``gatherer`` (the next one
    prefetched), the persistent tensors once a microbatch; the gradients
    land on the master shards (``targets``)."""

    def __init__(self, gatherer, master, persistent):
        self.g, self.master = gatherer, master
        self.keep = list(persistent)

    def open(self):
        return torch.autograd.graph.saved_tensors_hooks(self.g.pack, self.g.unpack)

    def persistent(self):
        return self.g.bind("persistent", self.keep, register=False) if self.keep else {}

    def block(self, name, keys):
        order = self.g.order
        i = order.index(name)
        if i + 1 < len(order):
            self.g.prefetch("forward", order[i + 1], self.g.blocks[order[i + 1]])
        return self.g.bind(name, self.g.blocks[name])

    def done(self, name):
        self.g.release(name)

    def targets(self):
        return list(self.master.values())


class ModelStage(PipeStage):
    """One rank's stage of ``model`` over a step's microbatches.

    ``batch``: the rank's stacked microbatches (``input_ids`` (M, b, T),
    optional ``labels`` and ``attention_mask``); ``src``: the tensor
    source; ``blocks``: :func:`stage_blocks`; ``denom``: the global valid
    count the cross entropy divides by; ``seed``: the side terms' backward
    seed (``loss_scale * gas``); ``aux_coef``: the MoE aux loss's factor;
    ``rngs``: the micro-steps' dropout keys (None without dropout);
    ``accumulate(m, grads)``: takes microbatch ``m``'s gradients of
    ``src.targets()``. ``parts[m]``: microbatch ``m``'s loss terms on this
    stage (its aux, and on the last stage its cross entropy), unscaled."""

    def __init__(self, model, index, num_stages, layers, blocks, src, batch, denom, seed=1.0, aux_coef=0.0,
                 rngs=None, accumulate=None, train=True):
        super().__init__(index, num_stages, train)
        self.model, self.layers, self.blocks, self.src = model, layers, blocks, src
        ids = batch["input_ids"]
        if "labels" in batch:
            labels, self.shift = batch["labels"], False
        else:
            labels, self.shift = ids[:, :, 1:], True
        self.ids, self.mask = ids, batch.get("attention_mask")
        self.valid = labels >= 0
        self.labels = torch.clamp(labels, min=0).long()
        self.denom, self.seed, self.aux_coef = denom, seed, aux_coef
        self.rngs, self._accumulate = rngs, accumulate
        self.moe = getattr(model.cfg, "num_experts", 0) > 0
        self.parts = {}

    def _tree(self, name, persist):
        keys = self.blocks[name]
        return {**self.src.block(name, keys), **{k: persist[k] for k in keys if k in persist}}

    def _layer_trees(self, persist):
        for i in self.layers:
            name, pre = f"layer{i}", f"layers.{i}."
            tree = self._tree(name, persist)
            yield {k[len(pre):]: v for k, v in tree.items()}
            self.src.done(name)

    def run(self, m, x):
        model = self.model
        with self.src.open():
            persist = self.src.persistent()
            h = x
            if self.first:
                h = model.stream_embed(self._tree("embed", persist), self.ids[m])
                self.src.done("embed")
            moe_out = [] if self.moe else None
            mask = None if self.mask is None else self.mask[m]
            rng = None if self.rngs is None else self.rngs[m]
            h = model.pipeline_stage(self._layer_trees(persist), h, self.layers.start, mask, rng, moe_out=moe_out)
            parts = []
            if moe_out:
                aux = sum(a for a, _ in moe_out)
                parts.append(aux * self.aux_coef)
                model.last_moe = {"aux_loss": aux.detach(),
                                  "drop_frac": torch.stack([d for _, d in moe_out]).detach()}
            if self.last:
                parts.append(model.stream_tail_loss(self._tree("tail", persist), h, self.labels[m], self.valid[m],
                                                    shift=self.shift, n_valid=self.denom))
                self.src.done("tail")
            del persist
        self.parts[m] = [p.detach().float() for p in parts]
        return (None if self.last else h), [p.float() * self.seed for p in parts]

    def targets(self):
        return self.src.targets()

    def accumulate(self, m, grads):
        self._accumulate(m, grads)

    def loss(self):
        """This stage's loss terms summed in microbatch order (0 when it
        holds none)."""
        total = torch.zeros((), dtype=torch.float32, device=self.ids.device)
        for m in sorted(self.parts):
            for p in self.parts[m]:
                total = total + p
        return total
