"""Every config key the JAX package reads is read by the port too, or is set
aside below with the reason it is not: a key a recipe sets and the port
ignores without a word would change nothing where the user expects a change
(ROADMAP §C: faults C3, C4 and C7 were such keys).

The reads are found in the sources: `cfg.A.B.C`, `cfg.A.get("B")`,
`getattr(cfg.A, "B")`, and `x.C` where `x = cfg.A.B` in the same file (the
config packages themselves, which declare every key, are not scanned). The
set-aside list must equal what the scan finds: a key that the port starts
reading leaves it, and a new key ignored without a word fails here.
"""

import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PATH = r"(?:[A-Z][A-Z0-9_]*)(?:\.[A-Z][A-Z0-9_]*)*"
READ = re.compile(r"\bcfg\.(" + PATH + r")")
ALIAS = re.compile(r"^\s*(\w+)\s*=\s*(?:self\.)?cfg\.(" + PATH + r")\s*(?:#.*)?$", re.M)
GET = re.compile(r"\bcfg\.(" + PATH + r")\.get\(\s*[\"']([A-Z][A-Z0-9_]*)[\"']")
GETATTR = re.compile(r"getattr\(\s*cfg\.(" + PATH + r")\s*,\s*[\"']([A-Z][A-Z0-9_]*)[\"']")

SET_ASIDE = {
    # TPU-runtime workarounds, not ported on purpose (ROADMAP §A); the
    # auction matcher exists because the TPU runtime rejects host callbacks;
    # SHARD_TOKENS is a GSPMD layout hint for the TPU's gather-row floor that
    # leaves the function unchanged, and under DDP each card holds whole images
    "TPU runtime": {"TPU.FUSED_MASKED_ATTN", "TPU.POINT_MATMUL_SAMPLING", "TPU.DONATE",
                    "TPU.SPLIT_STEP", "TPU.HOST_ACCUM", "TPU.EVAL_STREAM", "TPU.EVAL_BUCKET_STEP",
                    "TPU.SCAN_ENCODER", "TPU.MATCHER_HOST_EXACT", "TPU.SHARD_TOKENS"},
    # stored by the JAX head and never used (mp_former_tpu/models/meta_arch/
    # mask_former_head.py:47-48; IGNORE_VALUE is read by the evaluators)
    "stored, unused": {"MODEL.SEM_SEG_HEAD.LOSS_WEIGHT"},
}


def _reads(package: str) -> set:
    found = set()
    for path in (ROOT / package).rglob("*.py"):
        if path.parent.name == "config":
            continue
        src = path.read_text()
        found |= set(READ.findall(src))
        found |= {f"{a}.{b}" for a, b in GET.findall(src) + GETATTR.findall(src)}
        for name, base in ALIAS.findall(src):
            found |= {f"{base}.{k}" for k in re.findall(rf"\b{name}\.({PATH})", src)}
    # a read of A.B.C also names the nodes A and A.B: keys are the leaves
    return {k for k in found if not any(o.startswith(k + ".") for o in found)}


def test_every_key_the_jax_package_reads_is_read_or_set_aside():
    ignored = _reads("mp_former_tpu") - _reads("mp_former_tpu_torch")
    set_aside = set().union(*SET_ASIDE.values())
    assert ignored - set_aside == set(), "read by the JAX package, ignored by the port"
    assert set_aside - ignored == set(), "set aside, but read by the port (or by neither)"
    assert "TPU.PROFILE_DIR" in _reads("mp_former_tpu_torch")
    # the data-parallel size (`parallel/mesh.py:data_parallel_size`)
    assert {"TPU.MESH_SHAPE", "TPU.MESH_AXES"} <= _reads("mp_former_tpu_torch")


def test_video_training_builds_trainer_with_clip_loader(tmp_path, monkeypatch):
    """The port's video entry point without --eval-only trains: it builds the
    Trainer with the video model, the tube criterion and a loader of clips
    through the clip mapper, which reads the frame sampling keys."""
    from mp_former_tpu_torch import train_net_video
    from mp_former_tpu_torch.data.catalog import DatasetCatalog
    from mp_former_tpu_torch.engine.trainer import Trainer
    from mp_former_tpu_torch.models.meta_arch.video_maskformer import VideoMaskFormer
    from mp_former_tpu_torch.video import ytvis
    from mp_former_tpu_torch.video.criterion import VideoSetCriterion
    from tools.make_synthetic_ytvis_torch import write_dataset

    write_dataset(str(tmp_path), videos=1, frames=(2,), height=64, width=64, classes=40)
    monkeypatch.setenv("DETECTRON2_DATASETS", str(tmp_path))
    fresh = type(DatasetCatalog)()
    monkeypatch.setattr(ytvis, "DatasetCatalog", fresh)
    monkeypatch.setattr("mp_former_tpu_torch.data.catalog.DatasetCatalog", fresh)
    built = []
    monkeypatch.setattr(Trainer, "train", lambda self, start=None: built.append(self))
    args = train_net_video.default_argument_parser().parse_args(
        ["--config-file", "configs/youtubevis_2019/video_maskformer2_R50_bs16_8ep.yaml",
         "MODEL.DEVICE", "cpu", "MODEL.WEIGHTS", "", "MODEL.RESNETS.STEM_OUT_CHANNELS", "16",
         "MODEL.RESNETS.WIDTH_PER_GROUP", "16", "MODEL.RESNETS.RES2_OUT_CHANNELS", "64",
         "MODEL.SEM_SEG_HEAD.CONVS_DIM", "32", "MODEL.SEM_SEG_HEAD.MASK_DIM", "32",
         "MODEL.MASK_FORMER.HIDDEN_DIM", "32", "MODEL.MASK_FORMER.DIM_FEEDFORWARD", "64",
         "INPUT.SAMPLING_FRAME_RANGE", "3", "INPUT.SAMPLING_FRAME_SHUFFLE", "True",
         "OUTPUT_DIR", str(tmp_path / "out")])
    assert train_net_video.main(args) is None
    trainer, = built
    assert isinstance(trainer.model, VideoMaskFormer) and trainer.model.scalar == 0
    assert isinstance(trainer.criterion, VideoSetCriterion)
    mapper = trainer.train_loader.mapper
    assert isinstance(mapper, ytvis.YTVISDatasetMapper)
    assert (mapper.num_frames, mapper.frame_range, mapper.shuffle) == (2, 3, True)
    assert trainer.train_loader.collate.func is ytvis.collate_clips
    reads = _reads("mp_former_tpu_torch")
    assert {"INPUT.SAMPLING_FRAME_NUM", "INPUT.SAMPLING_FRAME_RANGE",
            "INPUT.SAMPLING_FRAME_SHUFFLE"} <= reads
