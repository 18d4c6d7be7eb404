"""BLIP2-FMR: the frame-level moment retrieval baseline, registered
``blip2_fmr`` (counterpart of ``mr_blip_tpu/models/blip2_fmr.py``; reference
``lavis/models/blip2_models/blip2_fmr.py``).

SeViLA-style: every frame is scored on its own. The T5 encoder sees one row
per frame, ``[Frame: | the frame's tokens | query + options]``, and the
frame's relevance is the "yes" logit minus the "no" logit at the first
decoding step. Frames above ``threshold`` form the predicted moments: a run
of them starts at its first frame's timestamp and ends at the next frame's
(the video's duration for a run that reaches the end).

The JAX ``_prepare`` casts the frames to float32, so uint8 frames reach its
ViT as raw 0-255 values; the port keeps them uint8 and CLIP-normalizes them
on the device, as ``BLIP2_MR`` does (ROADMAP Queue 3, known differences).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from mr_blip_tpu_torch.common.registry import registry
from mr_blip_tpu_torch.models.blip2_mr import BLIP2_MR


@registry.register_model("blip2_fmr")
class Blip2FMR(BLIP2_MR):
    """Per-frame yes/no relevance scorer over the BLIP-2 stack of ``BLIP2_MR``."""

    def __init__(self, frame_prefix: str = "Frame: ", threshold: float = 0.0, **kwargs):
        kwargs.setdefault("task", "fmr")
        super().__init__(**kwargs)
        self.frame_prefix = frame_prefix
        self.threshold = threshold
        # The reference hard-codes flan-t5's ids (4273 / 150); these come
        # from the tokenizer, as in the JAX package.
        self.yes_id = self.tokenizer.encode("yes", add_special_tokens=False)[-1]
        self.no_id = self.tokenizer.encode("no", add_special_tokens=False)[-1]

    def _prepare(self, samples, with_targets: bool) -> Dict[str, torch.Tensor]:
        """Frames, one ``frame_prefix`` and one query row per frame, and with
        ``with_targets`` the per-frame answers (``qa_output`` holds a video's
        answers joined by ``"_"``) -> tensors on the device."""
        video = samples["video"]
        if isinstance(video, torch.Tensor):
            if video.dtype != torch.uint8:
                video = video.float()
        else:
            video = np.asarray(video)
            if video.dtype != np.uint8:
                video = video.astype(np.float32)
        b, t = video.shape[:2]
        tok = self.tokenizer
        prefix = tok([self.frame_prefix], add_special_tokens=False)
        text = tok(list(samples["loc_input"]), truncation=True,
                   max_length=self.max_txt_len)
        batch = {"frames": video,
                 "prefix_ids": np.repeat(prefix.input_ids, b * t, axis=0),
                 "text_ids": np.repeat(text.input_ids, t, axis=0),
                 "text_mask": np.repeat(text.attention_mask, t, axis=0)}
        if with_targets:
            answers = [a for row in samples["qa_output"] for a in row.split("_")]
            if len(answers) != b * t:
                raise ValueError(f"{len(answers)} frame answers for {b} x {t} frames")
            target = tok(answers)
            batch["target_ids"] = target.input_ids
            batch["target_mask"] = target.attention_mask
        return self._to_device(batch)

    def _frame_rows(self, tensors):
        """-> (inputs_embeds, mask): one encoder row per frame."""
        frames = self.frames_to_t5(tensors)
        b, tn, d = frames.shape
        n = self.module.tokens_per_frame
        per_frame = frames.reshape(b * (tn // n), n, d)
        embed = self.module.t5.shared
        prefix = embed(tensors["prefix_ids"]).to(per_frame.dtype)
        text = embed(tensors["text_ids"]).to(per_frame.dtype)
        mask = tensors["text_mask"]
        ones = torch.ones((per_frame.shape[0], prefix.shape[1] + n), dtype=mask.dtype,
                          device=mask.device)
        return torch.cat([prefix, per_frame, text], dim=1), torch.cat([ones, mask], dim=1)

    def forward(self, samples) -> Dict[str, Any]:
        """``{"loss"}``: the teacher-forced yes/no loss over every frame."""
        tensors = self._prepare(samples, with_targets=True)
        embeds, mask = self._frame_rows(tensors)
        loss, _ = self.module.loss_from_encoder_input(
            embeds, mask, tensors["target_ids"], tensors["target_mask"])
        return {"loss": loss}

    __call__ = forward

    @torch.inference_mode()
    def frame_scores(self, samples) -> torch.Tensor:
        """(B, T) fp32: the "yes" minus the "no" logit of each frame's first
        decoding step, in eval mode."""
        tensors = self._prepare(samples, with_targets=False)
        training = self.module.training
        self.module.eval()
        try:
            embeds, mask = self._frame_rows(tensors)
            t5 = self.module.t5
            enc = t5.encode(embeds, mask=mask)
            start = torch.full((embeds.shape[0], 1), self.t5_config.decoder_start_token_id,
                               dtype=torch.long, device=embeds.device)
            logits = t5.decode(start, enc, encoder_mask=mask)[:, 0]
        finally:
            self.module.train(training)
        b, t = tensors["frames"].shape[:2]
        return (logits[:, self.yes_id] - logits[:, self.no_id]).reshape(b, t)

    def generate(self, samples) -> Dict[str, Any]:
        """Per-frame relevance scores -> thresholded yes/no and moments."""
        return self.answers(self.frame_scores(samples).cpu().numpy(), samples)

    def answers(self, scores: np.ndarray, samples) -> Dict[str, Any]:
        """(B, T) scores -> the yes/no answers above ``threshold`` and the
        moments they form."""
        pred = (scores > self.threshold).astype(int)
        timestamps = np.asarray(samples["timestamps"], np.float64)
        durations = np.asarray(samples["duration"], np.float64)
        moments = []
        for i in range(pred.shape[0]):
            spans, start = [], None
            for j in range(pred.shape[1]):
                if pred[i, j] and start is None:
                    start = timestamps[i, j]
                elif not pred[i, j] and start is not None:
                    spans.append([float(start), float(timestamps[i, j])])
                    start = None
            if start is not None:
                spans.append([float(start), float(durations[i])])
            moments.append(spans if spans else [[-1, -1]])
        return {
            "yes_score": scores,
            "pred_ans": pred.tolist(),
            "prediction": [str(m) for m in moments],
            "raw_prediction": [str(m) for m in moments],
            "answer": samples.get("relevant_windows"),
            "qid": samples.get("query_id"),
            "duration": [float(d) for d in durations],
        }
