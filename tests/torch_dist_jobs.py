"""Jobs that the port's multi-process tests run as gloo processes on the CPU.

``python tests/torch_dist_jobs.py <job> <spec.json>`` in each process of a
``parallel.launch.run_local`` job: it joins the process group that the
launcher's ``DST_*`` variables describe (collectives time out after 60 s),
runs the job and writes what the test compares into the spec's ``out``
directory.  It imports torch and the port only (no jax), so that a process
starts in about two seconds; the tests import its tiny configurations, so
that the one-process references run the same nets.
"""

import json
import os
import sys

import numpy as np
import torch

# nets the multi-process runs and their one-process references share (AMED taps
# the SongUNet bottleneck enc_8x8_block3: four blocks)
TINY_EDM = (dict(img_resolution=8, img_channels=3, label_dim=0, model_type="SongUNet"),
            dict(model_channels=8, channel_mult=[1], num_blocks=4, attn_resolutions=[8],
                 dropout=0.0))
# 8x8 latents, self-attention at T=64 (the ring dispatches once
# ring_attention._SP_MIN_TOKENS is patched down to RING_MIN_TOKENS)
TINY_LDM = dict(
    linear_start=0.0015, linear_end=0.0195, timesteps=1000, scale_factor=1.0,
    conditioning_key=None, first_stage="vq",
    unet=dict(image_size=8, in_channels=3, out_channels=3, model_channels=32,
              attention_resolutions=(1,), num_res_blocks=1, channel_mult=(1,),
              num_head_channels=16),
    vae=dict(z_channels=3, resolution=16, ch=32, ch_mult=(1, 2), num_res_blocks=1,
             attn_resolutions=()),
    n_embed=32, embed_dim=3)
RING_MIN_TOKENS = 8

SAMPLE_ARGS = ["--model_path=random", "--device=cpu", "--subdirs=False"]
DP_SAMPLE = ["--dataset_name=tiny8", "--seeds=0-7", "--batch=2", "--num_steps=4"]
GITS_SAMPLE = ["--dataset_name=tiny8", "--seeds=0-3", "--batch=2", "--dp=True",
               "--num_steps=3", "--num_steps_tea=7", "--num_warmup=4"]
SP_SAMPLE = ["--dataset_name=lsun_bedroom_ldm", "--seeds=0-3", "--batch=4", "--num_steps=3"]
AMED_ARGS = ["--dataset_name=cifar10", "--model_path=random", "--device=cpu", "--batch=512",
             "--batch_gpu=256", "--total_kimg=1", "--num_steps=3", "--tick=1"]
SFD_ARGS = ["--dataset_name=cifar10", "--model_path=random", "--device=cpu", "--batch=512",
            "--batch_gpu=256", "--total_kimg=1", "--num_steps=3", "--m=1", "--tick=1",
            "--snap=1"]
# the SongUNet's attention at 8x8 (T=64) rides the ring in the student's
# forward, remat's recompute and the backward
SFD_SP_ARGS = [*SFD_ARGS[:-2], "--afs=False", "--tick=2", "--snap=2"]


# Tensor parallelism and FSDP (tests/test_torch_tp.py, tests/test_torch_fsdp.py):
# the nets of the forward checks (EDM's SongUNet has one head: the gather
# path; the Dhariwal net's 128-channel level has 2; the SD-like LDM runs its
# spatial transformer's heads and GEGLU halves; the legacy LDM has 3 heads of
# 32, the gather path at an odd count)
TP_NETS = {
    "song": ("SongUNet", dict(img_resolution=8, in_channels=3, out_channels=3,
                              model_channels=8, channel_mult=[1], num_blocks=2,
                              attn_resolutions=[8], dropout=0.0)),
    "dhariwal": ("DhariwalUNet", dict(img_resolution=8, in_channels=3, out_channels=3,
                                      label_dim=4, model_channels=64, channel_mult=[1, 2],
                                      num_blocks=1, attn_resolutions=[4], dropout=0.0)),
    "ldm_sd": ("LDMUNet", dict(image_size=8, in_channels=4, out_channels=4, model_channels=32,
                               attention_resolutions=(2,), num_res_blocks=1, channel_mult=(1, 2),
                               num_heads=2, use_spatial_transformer=True, transformer_depth=1,
                               context_dim=24, legacy=False)),
    "ldm_legacy": ("LDMUNet", dict(image_size=8, in_channels=3, out_channels=3,
                                   model_channels=96, attention_resolutions=(1,),
                                   num_res_blocks=1, channel_mult=(1,), num_head_channels=32)),
}
TP_SAMPLE = [*DP_SAMPLE, "--tp=2"]
AMED_LDM_ARGS = ["--dataset_name=lsun_bedroom_ldm", "--model_path=random", "--device=cpu",
                 "--batch=64", "--batch_gpu=32", "--total_kimg=1", "--num_steps=3", "--tick=8"]
# FSDP's floor in the jobs: the tiny nets' weights are under the 2^14 elements
# of the real floor
FSDP_MIN_ELEMS = 256


def build_tp_net(name):
    """A full net of ``TP_NETS`` on the CPU (its weights uninitialised)."""
    from diff_sampler_tpu_torch.models import ldm, unets

    kind, kw = TP_NETS[name]
    cls = ldm.LDMUNet if kind == "LDMUNet" else getattr(unets, kind)
    return cls(device="cpu", **kw).eval()


def tp_net_call(name, net, data):
    """The forward of ``TP_NETS[name]`` on the test's inputs ``data``."""
    x, t = torch.as_tensor(data["x"]), torch.as_tensor(data["t"])
    if name == "ldm_sd":
        return net(x, t, torch.as_tensor(data["ctx"]))
    if name == "dhariwal":
        return net(x, t, torch.as_tensor(data["labels"]))
    return net(x, t)


def patch_tiers():
    """The tiny nets in place of the tiers' full ones (this process only)."""
    from diff_sampler_tpu_torch.models import factory
    from diff_sampler_tpu_torch.models import ldm

    factory.EDM_ARCHS["tiny8"] = TINY_EDM
    factory.EDM_ARCHS["cifar10"] = TINY_EDM
    ldm.LDM_CONFIGS["lsun_bedroom_ldm"] = TINY_LDM


def numpy_randn(seeds, shape, dtype=torch.float32, device="cpu"):
    """Per-seed standard normals from numpy, which the JAX side draws too."""
    rows = [np.random.RandomState(int(s)).standard_normal(tuple(shape)) for s in seeds]
    return torch.as_tensor(np.stack(rows).astype(np.float32), device=device).to(dtype)


def numpy_randint(seeds, shape, low, high, device="cpu"):
    rows = [np.random.RandomState(10_000 + int(s)).randint(low, high, tuple(shape))
            for s in seeds]
    return torch.as_tensor(np.stack(rows).astype(np.int64), device=device)


def label_means(n_labels: int, channels: int) -> np.ndarray:
    return np.linspace(-1.0, 1.0, n_labels * channels, dtype=np.float32).reshape(
        n_labels, channels)


def per_seed_rows(n: int, channels: int) -> np.ndarray:
    return np.random.RandomState(1).standard_normal((n, channels)).astype(np.float32)


def gaussian_denoise(x, t, mu):
    """The posterior mean of N(mu, I) data at noise level t (mu [B, C] or a
    scalar), in torch."""
    if torch.is_tensor(mu) and mu.dim() == 2:
        mu = mu[:, None, None, :]
    t = torch.as_tensor(t, dtype=x.dtype).reshape(-1, *([1] * (x.dim() - 1)))
    return mu + (x - mu) / (1.0 + t ** 2)


def _rank():
    from diff_sampler_tpu_torch.parallel.mesh import process_index

    return process_index()


def _save(spec, name, **arrays):
    np.savez(os.path.join(spec["out"], f"{name}.rank{_rank()}.npz"), **arrays)


def job_ring(spec):
    """Ring attention over one seq group of every process: sdpa with the
    layout installed (the kernel partial) and sp_sdpa(impl="reference"),
    forward and gradients; a second-order gradient; the ledger."""
    from diff_sampler_tpu_torch.ops import attention as A
    from diff_sampler_tpu_torch.ops import ring_attention as RA
    from diff_sampler_tpu_torch.parallel.mesh import make_layout, process_count

    layout = make_layout(process_count())
    RA.set_sp_context(layout)
    RA._SP_MIN_TOKENS = RING_MIN_TOKENS
    out = {}
    for case in ("fwd", "grad"):
        data = np.load(os.path.join(spec["out"], f"ring_{case}.npz"))
        scale = float(data["scale"])
        for impl in ("reference", "auto"):
            q, k, v = (torch.tensor(data[n], requires_grad=True) for n in "qkv")
            o = (A.sdpa(q, k, v, scale) if impl == "auto"
                 else RA.sp_sdpa(q, k, v, scale, impl="reference"))
            (o * torch.as_tensor(data["cot"])).sum().backward()
            out[f"{case}_{impl}_out"] = o.detach().numpy()
            for n, x in zip("qkv", (q, k, v)):
                out[f"{case}_{impl}_d{n}"] = x.grad.numpy()
    # second order: d/dq of <grad_q <o, cot>, w> through the ring
    data = np.load(os.path.join(spec["out"], "ring_grad.npz"))
    q, k, v = (torch.tensor(data[n], requires_grad=True) for n in "qkv")
    o = A.sdpa(q, k, v, float(data["scale"]))
    gq, = torch.autograd.grad((o * torch.as_tensor(data["cot"])).sum(), q, create_graph=True)
    (gq * torch.as_tensor(data["w"])).sum().backward()
    out["second_dq"], out["second_dk"] = q.grad.numpy(), k.grad.numpy()
    # the ledger at the JAX test's gate: T=256 rings twice, T=64 and T=520 do not
    RA._SP_MIN_TOKENS = 256
    RA.reset_sp_dispatch()
    for t in (256, 256, 64, 520):
        x = torch.randn(1, t, 2, 16, generator=torch.Generator().manual_seed(t))
        A.sdpa(x, x, x)
    counts = RA.sp_dispatch_counts()
    lines = []
    RA.log_sp_dispatch(lines.append)
    RA.set_sp_context(None)
    _save(spec, "ring", **out)
    with open(os.path.join(spec["out"], f"ledger.rank{_rank()}.json"), "w") as f:
        json.dump({"rang": {repr(k): n for k, n in counts["rang"].items()},
                   "skipped": {repr(k): r for k, r in counts["skipped"].items()},
                   "line": lines[0]}, f)


def job_generate(spec):
    """generate over the data ranks (unlabelled with its trajectory,
    labelled, per-seed rows), the stats Collector, JsonlWriter and
    create_run_dir."""
    from diff_sampler_tpu_torch import sampling as S
    from diff_sampler_tpu_torch.models.precond import BoundDenoiser
    from diff_sampler_tpu_torch.utils import checkpoint as ckpt
    from diff_sampler_tpu_torch.utils import stats

    S.stacked_randn, S.stacked_randint = numpy_randn, numpy_randint
    cfg = S.SolverConfig(**spec["cfg"])
    seeds, shape, mb = spec["seeds"], tuple(spec["shape"]), spec["max_batch_size"]
    means = torch.as_tensor(label_means(spec["label_dim"], shape[-1]))

    def den(mu):
        return BoundDenoiser(lambda x, t, c=None: gaussian_denoise(x, t, mu(c)), 0.002, 80.0)

    kw = dict(max_batch_size=mb, device="cpu")
    calls = []
    plain = S.generate(den(lambda c: 0.5), seeds, shape, cfg, **kw,
                       batch_callback=lambda start, x: calls.append((start, len(x))))
    traj = S.generate(den(lambda c: 0.5), seeds, shape, cfg, **kw, return_inters=True)
    labelled = S.generate(den(lambda c: c @ means), seeds, shape, cfg, **kw,
                          label_dim=spec["label_dim"])
    rows = per_seed_rows(len(seeds), shape[-1])
    per_seed = S.generate(den(lambda c: c), seeds, shape, cfg, **kw, per_seed_cond=rows)
    _save(spec, "generate", plain=plain, traj=traj, labelled=labelled, per_seed=per_seed,
          calls=np.asarray(calls))
    stats.report("m", [float(_rank() + 1)])
    stats.report0("only0", [10.0])
    c = stats.Collector()
    c.update()
    run_dir = ckpt.create_run_dir(os.path.join(spec["out"], "exps"), "mh")
    w = stats.JsonlWriter(os.path.join(run_dir, "stats.jsonl"))
    w.write(c, kimg=1.0)
    w.close()
    with open(os.path.join(spec["out"], f"stats.rank{_rank()}.json"), "w") as f:
        json.dump({"stats": c.as_dict(), "run_dir": run_dir}, f)


def job_sample_cli(spec):
    """The sampling CLI: seed-sharded PNGs, GITS, and --sp=2 on the tiny LDM."""
    from diff_sampler_tpu_torch.cli import sample
    from diff_sampler_tpu_torch.ops import ring_attention as RA

    patch_tiers()
    out = spec["out"]
    sample.main([*SAMPLE_ARGS, *DP_SAMPLE, f"--outdir={out}/dp"])
    gits = sample.main([*SAMPLE_ARGS, *GITS_SAMPLE, f"--outdir={out}/gits"])
    RA._SP_MIN_TOKENS = RING_MIN_TOKENS
    calls = []
    real = RA.sp_sdpa

    def spy(*a, **k):
        res = real(*a, **k)
        calls.append(res is not None)
        return res

    RA.sp_sdpa = spy
    sample.main([*SAMPLE_ARGS, *SP_SAMPLE, "--sp=2", f"--outdir={out}/sp"])
    with open(os.path.join(out, f"cli.rank{_rank()}.json"), "w") as f:
        json.dump({"dp_list": list(gits["dp_list"]), "rang": sum(calls),
                   "skipped": len(calls) - sum(calls)}, f)


def job_train(spec):
    """train_amed and train_sfd, data parallel, then each with --sp=2."""
    from diff_sampler_tpu_torch.cli import train_amed, train_sfd
    from diff_sampler_tpu_torch.ops import ring_attention as RA

    patch_tiers()
    out = spec["out"]
    runs = {"amed": train_amed.main([*AMED_ARGS, f"--outdir={out}/amed"]),
            "sfd": train_sfd.main([*SFD_ARGS, f"--outdir={out}/sfd"])}
    RA._SP_MIN_TOKENS = RING_MIN_TOKENS
    RA.reset_sp_dispatch()
    runs["sfd_sp"] = train_sfd.main([*SFD_SP_ARGS, "--sp=2", f"--outdir={out}/sfd_sp"])
    runs["rang"] = sum(RA.sp_dispatch_counts()["rang"].values())
    RA.reset_sp_dispatch()
    runs["amed_sp"] = train_amed.main([*AMED_ARGS, "--sp=2", f"--outdir={out}/amed_sp"])
    runs["amed_rang"] = sum(RA.sp_dispatch_counts()["rang"].values())
    with open(os.path.join(out, f"train.rank{_rank()}.json"), "w") as f:
        json.dump(runs, f)


def job_tp_fsdp(spec):
    """Tensor parallelism over one model group of 2 (``cases`` "tp"): the
    forwards of ``TP_NETS`` and the CG class-score gradient on the test's
    weights and inputs, shard-then-gather, and the CLIs (sample --tp=2,
    train_amed --tp=2, train_sfd --tp=2 and its --resume); FSDP over 2 data
    ranks (``cases`` "fsdp"): train_sfd --fsdp, --fsdp --sp=2 and
    train_amed --fsdp on the tiny LDM."""
    from diff_sampler_tpu_torch.cli import sample, train_amed, train_sfd
    from diff_sampler_tpu_torch.models import factory
    from diff_sampler_tpu_torch.parallel import fsdp, tp
    from diff_sampler_tpu_torch.parallel.mesh import make_layout

    patch_tiers()
    out = spec["out"]
    runs = {}
    if "tp" in spec["cases"]:
        layout = make_layout(tp=2)
        for name in TP_NETS:
            net = build_tp_net(name)
            full = {k: torch.as_tensor(v) for k, v in np.load(
                os.path.join(out, f"weights_{name}.npz")).items()}
            net.load_state_dict(full)
            tp.shard_tensor_parallel(net, layout)
            with torch.no_grad():
                y = tp_net_call(name, net, np.load(os.path.join(out, f"inputs_{name}.npz")))
            back = tp.gather_state_dict(net)
            _save(spec, f"fwd_{name}", out=y.numpy(), sharded=tp.count_sharded(net),
                  bytes=tp.tp_bytes_per_rank(net),
                  gathered=all(torch.equal(back[k], v) for k, v in full.items())
                  and back.keys() == full.keys())
        factory.IMAGENET256_SETTING = spec["cg_settings"]["net"]
        factory.IMAGENET256_CLASSIFIER_SETTING = spec["cg_settings"]["classifier"]
        pre, _ = factory.create_model("imagenet256", "random", guidance_rate=2.0, device="cpu")
        data = np.load(os.path.join(out, "cg.npz"))
        pre.net.load_state_dict({k[4:]: torch.as_tensor(v) for k, v in data.items()
                                 if k.startswith("net.")})
        pre.classifier.load_state_dict({k[4:]: torch.as_tensor(v) for k, v in data.items()
                                        if k.startswith("cls.")})
        factory.shard_pixel_tensor_parallel(pre, layout, "adm")
        with torch.no_grad():  # as the samplers call it
            grad = pre._cond_grad(torch.as_tensor(data["x"]), torch.as_tensor(data["t"]),
                                  torch.as_tensor(data["y"]))
        _save(spec, "cg", grad=grad.numpy(), sharded=tp.count_sharded(pre.classifier))
        sample.main([*SAMPLE_ARGS, *TP_SAMPLE, f"--outdir={out}/sample_tp"])
        runs["amed_tp"] = train_amed.main([*AMED_ARGS, "--tp=2", f"--outdir={out}/amed_tp"])
        runs["sfd_tp"] = train_sfd.main([*SFD_ARGS, "--tp=2", f"--outdir={out}/sfd_tp"])
        # resume the first snapshot under --tp: the last must be the unbroken run's
        runs["sfd_tp_resume"] = train_sfd.main([
            *SFD_ARGS, "--tp=2", f"--outdir={out}/sfd_tp_resume",
            f"--resume={runs['sfd_tp']}/snapshot-000000.npz"])
    if "fsdp" in spec["cases"]:
        fsdp._MIN_SHARD_ELEMS = FSDP_MIN_ELEMS
        runs["sfd_fsdp"] = train_sfd.main([*SFD_ARGS, "--fsdp", f"--outdir={out}/sfd_fsdp"])
        runs["sfd_fsdp_sp"] = train_sfd.main([*SFD_ARGS, "--fsdp", "--sp=2",
                                              f"--outdir={out}/sfd_fsdp_sp"])
        runs["amed_fsdp"] = train_amed.main([*AMED_LDM_ARGS, "--fsdp",
                                             f"--outdir={out}/amed_fsdp"])
    with open(os.path.join(out, f"runs.rank{_rank()}.json"), "w") as f:
        json.dump(runs, f)


JOBS = {"ring": job_ring, "generate": job_generate, "sample_cli": job_sample_cli,
        "train": job_train, "tp_fsdp": job_tp_fsdp}


if __name__ == "__main__":
    torch.set_num_threads(1)
    from diff_sampler_tpu_torch.parallel.mesh import maybe_initialize_distributed

    maybe_initialize_distributed("cpu", timeout_s=60)
    with open(sys.argv[2]) as f:
        JOBS[sys.argv[1]](json.load(f))
    # tear the group down before the interpreter does: a gloo group left to
    # the exit's destructors can abort the process ("terminate called
    # without an active exception") under load
    torch.distributed.destroy_process_group()
