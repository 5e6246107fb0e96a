"""The port's launcher and eval merges at world 2 (gloo on the CPU, spawned
ranks; ``tests/torch_dist.py``), and ``--mesh 2`` serving.

One spawn runs, on both ranks:

- ``run.main --task pretrain`` with a tiny model on a corpus of four image
  and two text files: a 4-step run whose ``--config`` is read from
  ``hdfs://`` and whose ``output_dir`` is mirrored to ``--output_hdfs``
  (the stand-in ``hdfs`` CLI of test_remote_staging.py), and a 2-step run
  that ``--resume`` takes to 4 steps; the ranks read disjoint file shards
  (the JAX ``split_shard``), rank 0 alone writes the state, and the resumed
  run ends in the whole run's state, every rank's cursor included, bit for
  bit;
- ``collect_results`` / ``collect_results_fs`` on shards with a duplicate
  key, held here against the JAX functions on the same shards;
- the retrieval rerank row-sharded over the ranks, merged, against the
  world-1 score matrices.
"""

import json
import os
from pathlib import Path

import numpy as np
import pytest
from tests.torch_threads import few_torch_threads  # noqa: E402,F401 (autouse)
import yaml

torch = pytest.importorskip("torch")

from tests.test_remote_staging import fake_hdfs  # noqa: E402,F401 (a fixture)
from tests.test_torch_launcher import VOCAB, _png  # noqa: E402
from tests.torch_dist import init_group, spawn  # noqa: E402
from x2vlm_tpu_torch.train.checkpoint import TRAIN_STATE_FILE  # noqa: E402

WORDS = VOCAB[5:]
RESULTS = [[{"question_id": 1, "answer": "a"}, {"question_id": 2, "answer": "b"}],
           [{"question_id": 3, "answer": "c"}, {"question_id": 2, "answer": "d"}]]


def _corpus(d: Path) -> None:
    (d / "bert-tiny").mkdir()
    (d / "bert-tiny" / "vocab.txt").write_text("\n".join(VOCAB))
    rng = np.random.default_rng(0)
    for name, n_files, line in (("img", 4, lambda: {
            "binary": __import__("base64").b64encode(_png(rng)).decode(),
            "desc": " ".join(rng.choice(WORDS, 8))}),
            ("txt", 2, lambda: {"text": " ".join(rng.choice(WORDS, 9))})):
        (d / name).mkdir()
        for i in range(n_files):
            with open(d / name / f"part{i}.jsonl", "w") as f:
                f.write("\n" * i)   # the ranks' cursors part: file i skips i lines
                for _ in range(6):
                    f.write(json.dumps(line()) + "\n")
    cfg = {"image_res": 32,
           "vision_config_inline": {"vision_width": 32, "patch_size": 16,
                                    "num_hidden_layers": 2, "num_attention_heads": 2},
           "text_encoder": str(d / "bert-tiny"), "text_num_hidden_layers": 4,
           "text_fusion_start_at": 2,
           "text_config_inline": {"vocab_size": len(VOCAB), "hidden_size": 32, "num_heads": 2,
                                  "intermediate_size": 64, "hidden_dropout": 0.1,
                                  "attn_dropout": 0.1},
           "embed_dim": 16, "max_tokens": 10, "max_words": 10, "max_masks": 3,
           "optimizer": {"lr": 1e-3, "weight_decay": 0.01},
           "schedular": {"epochs": 1, "num_warmup_steps": 100},
           "train_file": [str(d / "img")], "images": {"batch_size": 4, "num_workers": 2},
           "train_dataset_size": 16, "train_file_text": [str(d / "txt")],
           "texts": {"batch_size": 4, "iter_perc": 0.5}}
    (d / "cfg.yaml").write_text(yaml.safe_dump(cfg))


def _main(d: Path, name: str, config: str, *extra):
    from x2vlm_tpu_torch import run

    return run.main(["--task", "pretrain", "--config", config, "--output_dir",
                     str(d / f"out_{name}"), "--seed", "0", "--device", "cpu", *extra])


def _worker(rank, world, tmp):
    d = Path(tmp)
    init_group(rank, world, tmp)
    from x2vlm_tpu_torch.data.streaming import DistLineReader
    from x2vlm_tpu_torch.tasks import collect

    saves = []
    save = torch.save
    torch.save = lambda *a, **kw: (saves.append(str(a[1])), save(*a, **kw))[1]
    try:
        _main(d, "whole", "hdfs://test/cfg.yaml", "--epoch", "2",
              "--output_hdfs", "hdfs://test/mirror")
        _main(d, "split", str(d / "cfg.yaml"), "--epoch", "1")
        rec = _main(d, "split", str(d / "cfg.yaml"), "--epoch", "2", "--resume")
    finally:
        torch.save = save
    assert rec["pretrain_steps"] == [2, 4]
    shards = {k: DistLineReader([str(d / k)], seed=0, rank=rank,
                                world_size=world)._epoch_files(0) for k in ("img", "txt")}
    merged = collect.collect_results(RESULTS[rank], dedup_key="question_id")
    collect.collect_results_fs(RESULTS[rank], str(d / "fs"), "vqa", rank, world,
                               dedup_key="question_id", timeout_s=60)
    (d / f"rank{rank}.json").write_text(json.dumps({"saves": saves, "shards": shards,
                                                    "merged": merged}))
    _rerank(rank, world)


def _rerank(rank, world):
    """Row-sharded rerank at world 2 equals the world-1 score matrices."""
    from x2vlm_tpu_torch.models import BEiT2Config, BertConfig, XVLMConfig
    from x2vlm_tpu_torch.models.heads import XVLMForRetrieval
    from x2vlm_tpu_torch.tasks.retrieval import retrieval_scores

    cfg = XVLMConfig(vision=BEiT2Config(image_res=32, patch_size=16, embed_dim=32, depth=1,
                                        num_heads=2),
                     text=BertConfig(vocab_size=40, hidden_size=32, num_layers=2,
                                     fusion_layer=1, num_heads=2, intermediate_size=64,
                                     encoder_width=32), embed_dim=16)
    model = XVLMForRetrieval(cfg, dtype=torch.float32, device="cpu", seed=0).eval()
    gen = torch.Generator().manual_seed(1)
    n_img, n_txt = 7, 11
    img_e = torch.randn(n_img, 5, 32, generator=gen)
    txt_e = torch.randn(n_txt, 6, 32, generator=gen)
    img_f = torch.nn.functional.normalize(torch.randn(n_img, 16, generator=gen), dim=-1)
    txt_f = torch.nn.functional.normalize(torch.randn(n_txt, 16, generator=gen), dim=-1)
    atts = torch.ones(n_txt, 6, dtype=torch.int32)
    atts[::3, 4:] = 0
    args = (model, img_e, img_f, txt_e, txt_f, atts)
    want = retrieval_scores(*args, k_test=4, rerank_rows=2)
    got = retrieval_scores(*args, k_test=4, rerank_rows=2, host_id=rank, num_hosts=world)
    for g, w in zip(got, want):
        assert (g == -100).sum() == (w == -100).sum()
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)


def _tree_bytes(root: Path):
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


def test_launcher_collect_and_rerank_at_world2(fake_hdfs, tmp_path):  # noqa: F811
    from x2vlm_tpu.data.streaming import DistLineReader as JaxReader
    from x2vlm_tpu.tasks import collect as jax_collect

    _corpus(tmp_path)
    (fake_hdfs / "cfg.yaml").write_bytes((tmp_path / "cfg.yaml").read_bytes())
    spawn(_worker, tmp_path)
    ranks = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(2)]
    # rank 0 alone writes the train state
    assert ranks[0]["saves"] and not ranks[1]["saves"]
    # disjoint file shards, the JAX split
    for k in ("img", "txt"):
        files = [ranks[r]["shards"][k] for r in range(2)]
        assert not set(files[0]) & set(files[1])
        assert sorted(files[0] + files[1]) == sorted(str(p) for p in (tmp_path / k).iterdir())
        for r in range(2):
            assert files[r] == JaxReader([str(tmp_path / k)], rank=r, world_size=2,
                                         seed=0)._epoch_files(0)
    # the resumed run ends in the whole run's state, each rank's cursor included
    whole, split = (torch.load(tmp_path / f"out_{n}" / "ckpt" / TRAIN_STATE_FILE,
                               weights_only=False) for n in ("whole", "split"))
    assert whole["step"] == split["step"] == 4 and whole["count"] == 4
    assert whole["data_state"] == split["data_state"]
    cursors = whole["data_state"]
    assert cursors["world_size"] == 2 and cursors["ranks"][0] != cursors["ranks"][1]
    for part in ("params", "mu", "nu"):
        for k in whole[part]:
            assert torch.equal(whole[part][k], split[part][k]), (part, k)
    # the remote config was fetched, and the mirror equals output_dir byte for byte
    assert (tmp_path / "out_whole" / "cfg.yaml").is_file()
    assert _tree_bytes(fake_hdfs / "mirror") == _tree_bytes(tmp_path / "out_whole")
    # the merges equal the JAX functions on the same shards
    want = jax_collect.dedup_by_key(RESULTS[0] + RESULTS[1], "question_id")
    assert ranks[0]["merged"] == ranks[1]["merged"] == want
    for r in (1, 0):
        got = jax_collect.collect_results_fs(RESULTS[r], str(tmp_path / "jfs"), "vqa", r, 2,
                                             dedup_key="question_id", timeout_s=5)
    assert got == want
    assert json.loads((tmp_path / "fs" / "vqa.json").read_text()) == \
        json.loads((tmp_path / "jfs" / "vqa.json").read_text())
    assert sorted(os.listdir(tmp_path / "fs")) == sorted(os.listdir(tmp_path / "jfs"))


@pytest.mark.parametrize("task", ["retrieval", "grounding", "vqa"])
def test_mesh_2_serving_equals_one_device(task, tmp_path):
    """``--mesh 2`` exports ``nr_devices: 2``; the bundle served over two CPU
    replicas gives the single-device server's outputs."""
    from x2vlm_tpu_torch import serving
    from x2vlm_tpu_torch.export_serving import _tiny_config, export_bundle
    from x2vlm_tpu_torch.factory import build_model

    cfg = _tiny_config(task)
    model, _ = build_model(cfg, task, device="cpu", dtype=torch.float32, seed=1)
    manifest = export_bundle(model.eval(), cfg, task, str(tmp_path), batch_images=4,
                             batch_texts=4, mesh=2)
    assert manifest["nr_devices"] == 2
    cls = {"retrieval": serving.RetrievalServer, "grounding": serving.GroundingServer,
           "vqa": serving.VQAServer}[task]
    path = tmp_path / "params.npz"
    two = cls.from_npz(path, dtype=torch.float32, device="cpu")
    one = cls.from_npz(path, dtype=torch.float32, device="cpu", mesh=1)
    assert len(two.replicas) == 2 and len(one.replicas) == 1
    gen = torch.Generator().manual_seed(0)
    image = torch.randn(4, 32, 32, 3, generator=gen)
    ids = torch.randint(1, 40, (4, 8), generator=gen)
    atts = torch.ones(4, 8, dtype=torch.int32)
    atts[1, 5:] = 0
    if task == "retrieval":
        calls = [lambda s: s.encode_images(image), lambda s: s.encode_texts(ids, atts),
                 lambda s: s.itm_score(s.encode_images(image)[0],
                                       s.encode_texts(ids, atts)[0], atts)]
    elif task == "grounding":
        calls = [lambda s: s.predict(image, ids, atts)]
    else:
        ans = torch.randint(1, 40, (5, 4), generator=gen)
        calls = [lambda s: s.rank(image, ids, atts, ans, torch.ones(5, 4, dtype=torch.int32),
                                  k_test=3)]
    for call in calls:
        got, want = call(two), call(one)
        for g, w in zip(*(x if isinstance(x, tuple) else (x,) for x in (got, want))):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="does not split"):
        two._split(lambda m, x: x, [image[:3]])
