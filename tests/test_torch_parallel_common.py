"""The rank side of the port's parallelism tests (tests/test_torch_parallel.py
and tests/test_torch_parallel_train.py): worker functions that spawned
gloo ranks run on the CPU through pope_tpu_torch.parallel.launch.spawn.
Nothing here imports JAX or pope_tpu: the test processes compute pope_tpu's
side and hand inputs over as files (`inputs.pt`); each rank writes its
results to `rank<r>.pt` in the same directory. No tests here."""

import contextlib
import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

WORLD = 4  # ranks per spawn; 2-rank cases run on both halves of a (2, 2) mesh


def spawn_suite(work_dir, suite):
    """Run `suite` on WORLD gloo ranks of this host, rendezvous through a
    file under work_dir (test workers run side by side; TCP ports would
    clash); returns every rank's results."""
    from pope_tpu_torch.parallel.launch import spawn

    spawn(run_suite, WORLD, argv=(str(work_dir), suite), device="cpu", coordinator=f"file://{work_dir}/rendezvous",
          timeout=600)
    return [torch.load(os.path.join(work_dir, f"rank{r}.pt"), weights_only=False) for r in range(WORLD)]


def run_suite(mesh, work_dir, suite):
    torch.set_num_threads(1)
    inputs = torch.load(os.path.join(work_dir, "inputs.pt"), weights_only=False)
    out = {"parallel": parallel_suite, "train": train_suite}[suite](inputs)
    torch.save(out, os.path.join(work_dir, f"rank{dist.get_rank()}.pt"))


def _mesh(shape, names):
    return DeviceMesh("cpu", torch.arange(WORLD).reshape(shape), mesh_dim_names=names)


class Fields(torch.nn.Module):
    """A module's output fields `names`, as a tuple (a comparable forward)."""

    def __init__(self, module, names):
        super().__init__()
        self.module, self.names = module, names

    def forward(self, *args):
        out = self.module(*args)
        return tuple(getattr(out, n) for n in self.names)


class _SignRecorder:
    """torch.nn.functional with relu / leaky_relu recording the sign
    pattern of their inputs (one bool tensor per call, in call order)."""

    def __init__(self):
        self.masks = []

    def __getattr__(self, name):
        return getattr(torch.nn.functional, name)

    def relu(self, x, *args, **kwargs):
        self.masks.append(x.detach() > 0)
        return torch.nn.functional.relu(x, *args, **kwargs)

    def leaky_relu(self, x, *args, **kwargs):
        self.masks.append(x.detach() > 0)
        return torch.nn.functional.leaky_relu(x, *args, **kwargs)


@contextlib.contextmanager
def relu_signs():
    """Record the matcher's ReLU input signs (backbone and LoFTR layers):
    a ReLU whose input lies within rounding of 0 takes the other side in
    a run that sums in another order, and then moves gradients by far more
    than rounding (tests/test_torch_train.py)."""
    from pope_tpu_torch.models.matcher import backbone, transformer

    rec = _SignRecorder()
    saved = backbone.F, transformer.F
    backbone.F = transformer.F = rec
    try:
        yield rec
    finally:
        backbone.F, transformer.F = saved


def pair_mesh(axis):
    """Two 2-rank groups on `axis` ({0, 1} and {2, 3}): both run a case."""
    return _mesh((2, 2), ("x", axis))


# --- tests/test_torch_parallel.py ----------------------------------------------------------


def rank_array(rank):
    """Rank r's (3, 4) float32 input of the collective checks."""
    return np.random.default_rng(100 + rank).normal(0, 1, (3, 4)).astype(np.float32)


def parallel_suite(inputs):
    from pope_tpu_torch.ops.ring_attention import ring_attention
    from pope_tpu_torch.parallel import collectives as C
    from pope_tpu_torch.parallel.mesh import make_mesh, shard_batch, shard_params_tp
    from pope_tpu_torch.parallel.pipeline import pipeline_apply, pipeline_loss_and_grad, shard_stage_params

    r = dist.get_rank()
    out = {}
    # collectives against numpy
    x = torch.from_numpy(rank_array(r))
    C.STATS.reset()
    out["all_reduce"] = C.all_reduce(x).numpy()
    out["all_gather"] = C.all_gather(x, dim=1).numpy()
    out["broadcast"] = C.broadcast(x, 2).numpy()
    out["shift"] = C.shift(x).numpy()
    out["all_gather_arrays"] = C.all_gather_arrays({"a": x.numpy(), "b": [x.sum().item()]})
    out["reduce_dict"] = C.reduce_dict({"loss": x.sum(), "n": float(r)}, average=True)
    out["reduce_dict_sum"] = C.reduce_dict({"n": float(r)}, average=False)
    out["gather_to_main"] = C.gather_to_main({"rank": r})
    out["stats"] = C.STATS.snapshot()
    mesh = make_mesh(WORLD, tp=2)
    xs = x.clone().requires_grad_(True)
    y = C.psum_in_mesh(xs * (r + 1), "dp", mesh)
    (y * y).sum().backward()
    out["psum_in_mesh"], out["psum_grad"] = y.detach().numpy(), xs.grad.numpy()
    xg = x.clone().requires_grad_(True)
    g = C.gather_parts(xg, mesh.get_group("tp"), dim=0)
    (g * torch.arange(g.numel(), dtype=g.dtype).reshape(g.shape)).sum().backward()
    out["gather_parts_grad"] = xg.grad.numpy()
    batch = {"a": np.arange(8 * 6).reshape(8, 6), "b": np.arange(8 * 3).reshape(8, 3)}
    sb = shard_batch(mesh, batch, sp_axis=1)
    out["shard_batch"] = ({k: np.asarray(v) for k, v in sb.items()}, sorted(sb.split))

    # shard_params_tp: which leaves, and the sharded forwards
    tp_mesh = _mesh((2, 1, 2), ("x", "dp", "tp"))
    for name, (module, args) in inputs["tp_models"].items():
        shard_params_tp(tp_mesh, module)
        with torch.no_grad():
            y = module(*args)
        out[f"tp_{name}"] = ([n for n, p in module.named_parameters() if getattr(p, "tp_sharded", False)],
                             [t.numpy() for t in (y if isinstance(y, tuple) else (y,))])

    # GPipe
    pp = inputs["pipeline"]
    stage = lambda p, h: torch.tanh(h @ p["w"] + p["b"])

    def norm_stage(p, h):
        h = h @ p["w"] + p["b"]
        return h / torch.linalg.vector_norm(h, dim=-1, keepdim=True)

    mse = lambda o, t: ((o - t) ** 2).mean()
    m2 = pair_mesh("pp")
    loss, grads = pipeline_loss_and_grad(stage, mse, m2, "pp")(
        shard_stage_params(pp["stacked2"], m2, "pp"), pp["x"], pp["y"])
    out["pp2"] = (loss.item(), {k: v.numpy() for k, v in grads.items()})
    out["pp2_apply"] = pipeline_apply(stage, m2, "pp")(shard_stage_params(pp["stacked2"], m2, "pp"),
                                                       pp["x"]).detach().numpy()
    m22 = _mesh((2, 2), ("pp", "dp"))
    loss, grads = pipeline_loss_and_grad(stage, mse, m22, "pp", "dp")(
        shard_stage_params(pp["stacked2"], m22, "pp"), pp["x"], pp["y"])
    out["pp2_dp2"] = (loss.item(), {k: v.numpy() for k, v in grads.items()})
    try:
        pipeline_apply(stage, m2, "pp")(shard_stage_params(pp["stacked4"], m2, "pp"), pp["x"])
        out["mismatch"] = None
    except ValueError as e:
        out["mismatch"] = str(e)
    loss, grads = pipeline_loss_and_grad(norm_stage, mse, m2, "pp")(
        shard_stage_params(pp["stacked2"], m2, "pp"), pp["x"], torch.zeros_like(pp["x"]))
    out["bubble"] = (loss.item(), {k: v.numpy() for k, v in grads.items()})

    # ring attention over sp = 2: this rank's token block
    sp = pair_mesh("sp")
    s, n = sp.get_local_rank("sp"), 2
    attn = ring_attention(sp, "sp")
    for name, (q, k, v) in inputs["ring"].items():
        N = q.shape[-2]
        block = lambda t: t[..., s * N // n:(s + 1) * N // n, :].clone().requires_grad_(True)
        ql, kl, vl = block(q), block(k), block(v)
        o = attn(ql, kl, vl)
        res = {"out": o.detach().float().numpy(), "dtype": str(o.dtype)}
        if q.dtype == torch.float32:
            (o.float() ** 2).sum().backward()
            res["grads"] = [t.grad.numpy() for t in (ql, kl, vl)]
        out[f"ring_{name}"] = res
    return out


# --- tests/test_torch_parallel_train.py ----------------------------------------------------


def _grads(module):
    """{name: full gradient}, tp shards gathered."""
    from pope_tpu_torch.parallel.collectives import all_gather

    out = {}
    for mod_name, mod in module.named_modules():
        for pn, p in mod.named_parameters(recurse=False):
            g = p.grad
            if g is not None and getattr(p, "tp_sharded", False):
                g = all_gather(g, mod.tp_shard.group)
            out[f"{mod_name}.{pn}" if mod_name else pn] = None if g is None else g.clone()
    return out


def train_suite(inputs):
    from pope_tpu_torch.eval import evaluate_dataset
    from pope_tpu_torch.eval import manifest as port_manifest
    from pope_tpu_torch.models.regressor import train as rtrain
    from pope_tpu_torch.parallel.collectives import STATS, all_gather
    from pope_tpu_torch.parallel.mesh import shard_batch, shard_params_tp, tp_gathered
    from pope_tpu_torch.pipeline import PipelineExecutor
    from pope_tpu_torch.train import trainer
    from pope_tpu_torch.train.ssl import (
        fsdp_gathered,
        make_sharded_ssl_step,
        shard_ssl_batch,
        shard_ssl_state,
        ssl_state_bytes,
    )

    out = {}
    dp2 = _mesh((2, 2, 1), ("x", "dp", "tp"))
    tp2 = _mesh((2, 1, 2), ("x", "dp", "tp"))

    # stage 2 over dp = 2: build_batched(mesh=) on the global batch
    ev = inputs["eval"]
    ex = PipelineExecutor(ev["models"], crop_size=ev["crop"])
    out["batched"] = [t.numpy() for t in ex.batched(mesh=dp2)(*ev["args"], packed=True)]

    # the eval driver over dp = 2, B = 4 (and a ragged 3-pair run)
    ds = inputs["dataset"]
    spec = port_manifest.DATASETS["linemod"]
    port_manifest.DATASETS["linemod"] = dataclasses.replace(spec, crop_size=ds["crop"])
    from pope_tpu_torch.pipeline import runner

    recs = []
    finish = runner.finish_pairs

    def capture(pending):
        got = finish(pending)
        recs.extend(got)
        return got

    runner.finish_pairs = capture
    try:
        for name, kw in (("eval_b4", {}), ("eval_ragged", {"max_pairs": 3})):
            recs.clear()
            tables = evaluate_dataset(ds["models"], "linemod", ds["root"], ds["pairs"], batch_size=4, progress=False,
                                      mesh=dp2, **kw)
            out[name] = (list(recs), tables)
    finally:
        runner.finish_pairs = finish

    # the matcher's train step over dp = 2 and tp = 2
    mt = inputs["matcher"]
    for name, mesh in (("matcher_dp", dp2), ("matcher_tp", tp2)):
        state = trainer.init_matcher_train_state(torch.load(mt["model"], weights_only=False), mt["ocfg"],
                                                 grad_clip=mt["clip"])
        shard_params_tp(mesh, state.model, optimizer=state.optimizer)
        STATS.reset()
        with relu_signs() as signs:
            metrics = trainer.make_sharded_train_step(mesh)(state, shard_batch(mesh, mt["batch"]))
        with tp_gathered(state.model, state.optimizer):
            after = {k: v.clone() for k, v in state.model.state_dict().items()}
        out[name] = {"metrics": {k: v.item() for k, v in metrics.items()}, "grads": _grads(state.model),
                     "state": after, "comm": STATS.snapshot(), "signs": signs.masks}

    # the SSL step over dp = 2, FSDP state
    for name, case in inputs["ssl"].items():
        arch, state = case["arch"], torch.load(case["state"], weights_only=False)
        whole = ssl_state_bytes(state)
        shard_ssl_state(state, dp2, min_size=case["min_size"])
        grads = {}
        update = arch._apply_update

        def spy(st, sched, mults):
            for n, p in st.student.named_parameters():
                g = p.grad
                if g is not None and n in st.fsdp.names:
                    g = all_gather(g, st.fsdp.group)
                grads[n] = None if g is None else g.clone()
            update(st, sched, mults)

        arch._apply_update = spy
        state, metrics = make_sharded_ssl_step(arch, dp2)(state, shard_ssl_batch(dp2, case["batch"]))
        arch._apply_update = update
        sharded = ssl_state_bytes(state)
        with fsdp_gathered(state):
            sd = {k: ({n: t.clone() for n, t in v.items()} if isinstance(v, dict) else v)
                  for k, v in state.state_dict().items()}
        out[name] = {"metrics": {k: v.item() for k, v in metrics.items()}, "grads": grads, "state": sd,
                     "bytes": (whole, sharded), "n_sharded": len(state.fsdp.names)}

    # train_ssl over dp = 2 (one stream of global batches)
    from pope_tpu_torch.train.ssl_driver import train_ssl

    sd = inputs["ssl_driver"]
    state = train_ssl(sd["root"], sd["cfg"], sd["bcfg"], mesh=dp2, device="cpu", **sd["kw"])
    with fsdp_gathered(state):
        out["ssl_driver"] = {k: ({n: t.clone() for n, t in v.items()} if isinstance(v, dict) else v)
                             for k, v in state.state_dict().items()}

    # the regressor's step over dp = 2 x tp = 2
    rg = inputs["regressor"]
    mesh = _mesh((2, 2), ("dp", "tp"))
    state = rtrain.create_train_state(torch.load(rg["model"], weights_only=False), rg["cfg"])
    shard_params_tp(mesh, state.model, optimizer=state.optimizer)
    metrics = rtrain.make_sharded_train_step(mesh)(state, shard_batch(mesh, rg["batch"], sp_axis=1), rg["masks"])
    moments = {}
    with tp_gathered(state.model, state.optimizer):
        after = {k: v.clone() for k, v in state.model.state_dict().items()}
        for n, p in state.model.named_parameters():
            moments[n] = state.optimizer.state[p]["exp_avg"].clone()
    out["regressor"] = {"metrics": {k: v.item() for k, v in metrics.items()}, "grads": _grads(state.model),
                        "state": after, "moments": moments}

    # train_matcher over dp = 2 (ranks 0, 1) and over tp = 2 (ranks 2, 3),
    # each half into its own checkpoint directory: one epoch, then a resume
    # to two
    from pope_tpu_torch.train.matcher_driver import train_matcher

    td = inputs["matcher_driver"]
    key, mesh = ("dp", dp2) if dp2.get_local_rank("x") == 0 else ("tp", tp2)
    runs = []
    for epochs, resume in ((1, False), (2, True)):
        state, history = train_matcher(torch.load(mt["model"], weights_only=False), td["train"], td["val"],
                                       dataclasses.replace(td["cfg"], epochs=epochs), batch_size=td["batch_size"],
                                       mesh=mesh, ckpt_dir=os.path.join(td["root"], key), resume=resume,
                                       log_every=100, num_workers=1, device="cpu")
        runs.append({"history": history, "step": state.step,
                     "tp_sharded": sum(getattr(p, "tp_sharded", False) for p in state.model.parameters())})
    out["matcher_driver"] = {"mesh": key, "runs": runs}
    return out
