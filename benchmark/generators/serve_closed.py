"""Closed-loop serving: one client hands the program batch after batch,
with at most ``depth`` batches handed over ahead of the one it waits for.

Parameters (the traffic mix's file, ``traffic/<mix>.json``): ``batch``,
``height``, ``width``, ``pool`` (distinct batches made at set-up), ``depth``,
``warmup`` (calls at set-up, every shape the window uses),
``traced_batches`` and ``trace_after`` (the traced slice), ``keep`` (how
many batches, drawn from the seed among the first ``keep_from``, are judged
besides the last one complete in the window).

The pool is uint8 noise drawn on the card from the seed and held in pinned
host memory, the input that the entry's ``non_blocking`` copy is written
for; every batch goes to the program as a host tensor, so its upload is
inside the window. Batch ``k`` is pool entry ``k % pool``.
"""

from __future__ import annotations

import random
import time

import numpy as np


class Serve:
    def __init__(self, ctx, program_cls, reference, params, stats):
        torch, tp = ctx.torch, ctx.cell["traffic_params"]
        self.ctx, self.tp, self.reference = ctx, tp, reference
        self.params, self.stats = params, stats
        shape = (tp["batch"], tp["height"], tp["width"], 3)
        g = ctx.generator(stream=1)
        self.pool = []
        for _ in range(tp["pool"]):
            x = torch.randint(0, 256, shape, generator=g, device=ctx.device, dtype=torch.uint8)
            host = torch.empty(shape, dtype=torch.uint8, pin_memory=ctx.device.type == "cuda")
            host.copy_(x)
            self.pool.append(host)
        del x
        ctx.mark("pool")
        self.program = program_cls(ctx.cfg, params, stats, ctx.cell, ctx.device,
                                   reference=reference if ctx.control else None)
        if ctx.fault != "none":
            from core import load_module

            self.program = load_module("programs/faults.py").Planted(self.program, ctx.fault)
        ctx.mark("program")
        rng = random.Random(ctx.seed)
        self.keep = set(rng.sample(range(tp["keep_from"]), tp["keep"]))
        for k in range(tp["warmup"]):
            self.step(k)
        if ctx.device.type == "cuda":
            torch.cuda.synchronize()
        ctx.mark("warmup")

    def step(self, k: int):
        x = self.pool[k % len(self.pool)]
        return self.program.step(x), x.shape[0]

    def window(self, seconds: float, trace: bool, event=None):
        from core import closed_loop

        tp = self.tp
        return closed_loop(self.ctx.torch, self.step, seconds, tp["depth"], self.keep,
                           trace_items=tp["traced_batches"] if trace else 0,
                           trace_after=tp["trace_after"], event=event)

    def judge(self, win) -> dict:
        """Free the program, then hold every kept batch's outputs against
        the reference on the same inputs."""
        torch = self.ctx.torch
        idx = sorted(win.kept)
        outs = [self.program.to_host(win.kept[k]) for k in idx]
        inputs = np.concatenate([self.pool[k % len(self.pool)].numpy() for k in idx])
        win.kept.clear()
        self.program.close()
        self.pool = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()
        merged = {key: np.concatenate([o[key] for o in outs]) for key in outs[0]}
        if list(merged) == ["masks"]:
            merged = merged["masks"]
        return self.reference.judge(self.ctx.cfg, self.params, self.stats, inputs, merged,
                                    self.ctx.device)


def setup(ctx):
    from core import load_module

    reference = load_module(f"reference/{ctx.cfg['name']}.py")
    program_cls = load_module(f"programs/{ctx.cell['program']}.py").Program
    ctx.mark("modules")
    params, stats = ctx.weights()
    ctx.mark("weights")
    if hasattr(reference, "calibrate"):
        # the reference's own work, on the host, so that the card's first
        # library calls stay the program's: its seconds are not set-up's
        tp = ctx.cell["traffic_params"]
        g = ctx.generator(stream=2)
        calib = ctx.torch.randint(0, 256, (2, tp["height"], tp["width"], 3), generator=g,
                                  device=ctx.device, dtype=ctx.torch.uint8)
        t = time.perf_counter()
        reference.calibrate(ctx.cfg, params, stats, calib.cpu())
        ctx.reference_s += time.perf_counter() - t
        ctx.mark("calibrate")
    return Serve(ctx, program_cls, reference, params, stats)
