"""The `pipeline` feed: raw record blocks written under TMPDIR in
set-up, the port's five-stage `train_feed` chain at designed cost 0
(each stage does its own transform and no more), its source stage
reading the files, the mix's `workers` a stage pinned to `pin_cpus`
cores, and `make_train_feed`'s device prefetch of `device_depth`. A raw
record holds the mix's `k_raw` values a feature (1 where it names
none), pooled to the configuration's `multi_hot`."""
from __future__ import annotations

import math
import shutil
import tempfile

import torch

from perfbench.lib import traffic


class PipelineFeed:
    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        import multiprocessing as mp

        from repro_torch.data.device_feed import make_train_feed
        from repro_torch.data.featurize import (RecordSpec,
                                                featurize_stage_fns)
        from repro_torch.data.pipeline import train_feed_pipeline
        from repro_torch.data.proc_executor import ProcessPipeline

        from perfbench.lib.feedsource import FileBlocks
        raw = traffic.make(cfg, mix, seed, device, raw=True)
        self.dir = tempfile.mkdtemp(prefix="perfbench_feed_")
        self.paths = traffic.write_raw_blocks(raw, self.dir)
        self.raw = [{k: v.cpu().numpy() for k, v in b.items()} for b in raw]
        del raw
        spec = train_feed_pipeline(cpu_share=0.0)
        record = RecordSpec(batch=mix["batch"], n_sparse=cfg["n_sparse"],
                            n_dense=cfg["n_dense"], vocab=cfg["rows"],
                            k_raw=traffic.k_raw(mix),
                            hot=int(cfg.get("multi_hot", 1)))
        fns = featurize_stage_fns(spec, ballast=False, record=record)
        fns[spec.stages[0].name] = FileBlocks(self.paths)
        self.pipe = ProcessPipeline(spec, fns=fns, pin_cpus=mix["pin_cpus"],
                                    ctx=mp.get_context("spawn"))
        self.pipe.set_allocation(mix["workers"], self.pipe.prefetch_mb)
        self.feed = make_train_feed(self.pipe, depth=mix["device_depth"],
                                    device=device)

    def next(self):
        return next(self.feed)

    def counters(self) -> dict:
        return self.feed.counters()

    def check(self, cfg: dict, delivered: list):
        """The delivered batches against the reference's featurization of
        the raw blocks; the reference's own rows, in the delivered order,
        stand for them in the training check."""
        from perfbench.reference import featurize as ref_feat
        hot = int(cfg.get("multi_hot", 1))
        expected = [ref_feat.featurize(b, cfg["rows"], hot=hot)
                    for b in self.raw]
        keys = [ref_feat.block_key(e["sparse_ids"]) for e in expected]
        mismatch, gap, out = 0, 0.0, []
        for d in delivered:
            dn = {k: v.cpu().numpy() for k, v in d.items()}
            key = ref_feat.block_key(dn["sparse_ids"].astype("int64"))
            if key not in keys:
                mismatch += dn["label"].shape[0]
                gap = math.inf
                out.append(d)
                continue
            e = expected[keys.index(key)]
            bad, g, order = ref_feat.compare(dn, e)
            mismatch += bad
            gap = max(gap, g) if not math.isnan(g) else math.nan
            dev = d["sparse_ids"].device
            out.append({"sparse_ids": torch.from_numpy(
                            e["sparse_ids"][order]).to(dev, torch.int32),
                        "dense": torch.from_numpy(e["dense"][order]).to(
                            dev, torch.float32),
                        "label": torch.from_numpy(e["label"][order]).to(
                            dev, torch.float32)})
        return {"feat_mismatch": mismatch, "dense_gap": gap}, out

    def control(self, cfg: dict) -> dict:
        """The dense transform's control: the reference's in bf16."""
        from perfbench.reference import featurize as ref_feat
        hot = int(cfg.get("multi_hot", 1))
        raw = self.raw[0]
        e = ref_feat.featurize(raw, cfg["rows"], hot=hot)
        c = ref_feat.featurize(raw, cfg["rows"], precision="bf16", hot=hot)
        return {"dense_gap": float(abs(c["dense"] - e["dense"]).max())}

    def close(self):
        self.feed.close()
        self.pipe.shutdown(drain=False)
        shutil.rmtree(self.dir, ignore_errors=True)


def make(cfg: dict, mix: dict, seed: int, device) -> PipelineFeed:
    return PipelineFeed(cfg, mix, seed, device)
