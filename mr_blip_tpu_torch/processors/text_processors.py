"""Text processors (caption/question pre-tokenization cleanup; the port's
copy of ``mr_blip_tpu/processors/text_processors.py``).

Mirror the reference ``BlipQuestionProcessor``
(lavis/processors/blip_processors.py:73-130): lowercase, strip punctuation
variants, cap word count. The caption processor waits for the zoo tasks.
"""

from __future__ import annotations

import re

from mr_blip_tpu_torch.common.registry import registry


class BaseProcessor:
    def __call__(self, item):
        return item

    @classmethod
    def from_config(cls, cfg=None):
        return cls()


@registry.register_processor("blip_question")
class BlipQuestionProcessor(BaseProcessor):
    def __init__(self, max_words: int = 50):
        self.max_words = max_words

    def __call__(self, question: str) -> str:
        return self.pre_question(question)

    @classmethod
    def from_config(cls, cfg=None):
        cfg = cfg or {}
        return cls(max_words=cfg.get("max_words", 50))

    def pre_question(self, question: str) -> str:
        question = re.sub(r"([.!\"()*#:;~])", "", question.lower())
        question = question.rstrip(" ")
        words = question.split(" ")
        if len(words) > self.max_words:
            question = " ".join(words[: self.max_words])
        return question
