"""The BLIP2-MR float generate and train paths: EVA ViT-g, Q-Former, Flan-T5,
and the decoder-only variant over OPT.

``load_model(name, model_type)`` builds a registered family from its default
YAML (counterpart of ``mr_blip_tpu/models/__init__.py``, reference
``lavis.models.load_model``); ``load_model_and_preprocess`` adds the
family's processors; ``model_zoo`` lists the families and their types.
"""

from __future__ import annotations

# Families of the JAX package's registry that the port has not ported, by
# the title of their ROADMAP Queue 1 item.
UNPORTED_FAMILIES = {"blip2_fmr": "Variants of BLIP2_MR"}
ZOO_ITEM = "Dormant LAVIS zoo"
ZOO_FAMILIES = (
    "albef_classification", "albef_feature_extractor", "albef_nlvr", "albef_nlvr_model",
    "albef_pretrain", "albef_retrieval", "albef_vqa", "alpro_qa", "alpro_retrieval",
    "blip2", "blip2_feature_extractor", "blip2_image_text_matching", "blip2_opt",
    "blip2_t5", "blip_caption", "blip_classification", "blip_feature_extractor",
    "blip_image_text_matching", "blip_nlvr", "blip_pretrain", "blip_retrieval",
    "blip_v1", "blip_vqa", "clip", "clip_feature_extractor", "gpt_dialogue",
    "gpt_dialogue_model", "img2prompt_vqa", "pnp_unifiedqav2_fid", "pnp_vqa",
    "timesformer")


def _model_class(name: str):
    import mr_blip_tpu_torch  # noqa: F401  (registers the port's models)
    from mr_blip_tpu_torch.common.registry import registry

    model_cls = registry.get_model_class(name)
    if model_cls is not None:
        return model_cls
    item = UNPORTED_FAMILIES.get(name, ZOO_ITEM if name in ZOO_FAMILIES else None)
    if item is not None:
        raise NotImplementedError(f"model {name!r} is not ported yet "
                                  f"(ROADMAP Queue 1, \"{item}\")")
    raise ValueError(f"unknown model {name!r}")


def load_model(name, model_type=None, is_eval=False, checkpoint=None,
               device="cuda", **kwargs):
    """Build a registered model from its default config: the ``model:``
    section of its YAML with ``kwargs`` over it, ``from_config(cfg,
    device=device)`` (the card unless ``device="cpu"``), then ``checkpoint``
    (a ``torch.save`` state dict) loaded non-strict. ``is_eval`` is accepted
    for the reference's signature: the model is built in eval mode.

    >>> model = load_model("blip2_mr", "pretrain_flant5xl")
    """
    from mr_blip_tpu_torch.common.config import load_yaml

    model_cls = _model_class(name)
    cfg_path = model_cls.default_config_path(model_type)
    cfg = dict(load_yaml(cfg_path)["model"]) if cfg_path else {}
    cfg.update(kwargs)
    model = model_cls.from_config(cfg, device=device)
    if checkpoint:
        model.load_state_dict(model.load_params_nonstrict(model.state_dict(), checkpoint))
    return model


def load_model_and_preprocess(name, model_type=None, is_eval=False, device="cuda",
                              **kwargs):
    """(model, vis_processors, txt_processors) as the reference returns them:
    the video processors at the model's image size emitting uint8 frames
    (``normalize=False``: the model normalizes on the device) and the text
    processors (``blip_question`` for both splits)."""
    from mr_blip_tpu_torch.processors.text_processors import BlipQuestionProcessor
    from mr_blip_tpu_torch.processors.video_processors import (
        Blip2VideoTrainProcessor,
        BlipVideoEvalProcessor,
    )

    model = load_model(name, model_type=model_type, is_eval=is_eval, device=device,
                       **kwargs)
    img = getattr(model, "img_size", 224)
    vis_processors = {
        "train": Blip2VideoTrainProcessor(image_size=img, normalize=False),
        "eval": BlipVideoEvalProcessor(image_size=img, normalize=False),
    }
    txt_processors = {"train": BlipQuestionProcessor(), "eval": BlipQuestionProcessor()}
    return model, vis_processors, txt_processors


class ModelZoo:
    """The registered families and their model types::

        >>> from mr_blip_tpu_torch.models import model_zoo
        >>> print(model_zoo)      # table of architectures and types
        >>> len(model_zoo)        # total (arch, type) count
    """

    def _table(self):
        import mr_blip_tpu_torch  # noqa: F401  (registers the port's models)
        from mr_blip_tpu_torch.common.registry import registry

        return {name: list(getattr(m, "PRETRAINED_MODEL_CONFIG_DICT", {"default": None}))
                for name, m in sorted(registry.mapping["model_name_mapping"].items())}

    def __str__(self) -> str:
        rows = self._table()
        return ("=" * 50 + "\n" + f"{'Architectures':<32} {'Types'}\n" + "=" * 50 + "\n"
                + "\n".join(f"{n:<32} {', '.join(t)}" for n, t in rows.items()))

    def __iter__(self):
        return iter(self._table().items())

    def __len__(self):
        return sum(len(t) for t in self._table().values())


model_zoo = ModelZoo()

__all__ = ["load_model", "load_model_and_preprocess", "model_zoo"]
