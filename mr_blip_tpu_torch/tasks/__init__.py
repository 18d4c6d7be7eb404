"""Tasks. Importing registers the task classes; setup_task resolves by name
(the port's counterpart of ``mr_blip_tpu/tasks/__init__.py``: the
moment-retrieval task, temporal action localization, the Mr. BLIP QA
tasks videoqa, videogqa and frameqa, and the zoo's captioning, retrieval and
multimodal classification; the other zoo tasks wait for their families,
ROADMAP Queue 1)."""

from mr_blip_tpu_torch.common.registry import registry
from mr_blip_tpu_torch.tasks.base_task import BaseTask
from mr_blip_tpu_torch.tasks.captioning import CaptionTask, MultimodalClassificationTask
from mr_blip_tpu_torch.tasks.moment_retrieval import MomentRetrievalTask
from mr_blip_tpu_torch.tasks.retrieval import RetrievalTask
from mr_blip_tpu_torch.tasks.temporal_action_localization import TALTask
from mr_blip_tpu_torch.tasks.vqa import FrameQA, VideoGQA, VideoQA


def setup_task(cfg):
    assert "task" in cfg.run_cfg, "Task name must be provided."
    task_name = cfg.run_cfg.task
    task_cls = registry.get_task_class(task_name)
    assert task_cls is not None, f"unknown task {task_name!r}"
    return task_cls.setup_task(cfg=cfg)


__all__ = ["BaseTask", "MomentRetrievalTask", "TALTask", "VideoQA", "VideoGQA",
           "FrameQA", "CaptionTask", "MultimodalClassificationTask", "RetrievalTask",
           "setup_task"]
