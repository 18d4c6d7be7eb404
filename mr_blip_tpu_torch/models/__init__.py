"""The BLIP2-MR float generate and train paths: EVA ViT-g, Q-Former, Flan-T5,
the decoder-only variant over OPT and the frame-level baseline
(``blip2_fmr``); of the LAVIS zoo, the BLIP-v1 wrappers (captioning,
retrieval, classification, NLVR, VQA, feature extraction, ITM,
pretraining), CLIP (``clip``) and the ALBEF wrappers (NLVR, retrieval,
pretraining, classification: ``models/zoo_wrappers.py``), and the modules
registered by name as in JAX (``blip_v1``, ``clip_feature_extractor``,
``albef_feature_extractor``, ``albef_nlvr``, ``albef_vqa``: ``load_model``
raises ``AttributeError`` on them, as JAX's does, since a module has no
default config).

``load_model(name, model_type)`` builds a registered family from its default
YAML (counterpart of ``mr_blip_tpu/models/__init__.py``, reference
``lavis.models.load_model``); ``load_model_and_preprocess`` adds the
family's processors; ``model_zoo`` lists the families and their types.
"""

from __future__ import annotations

# Families of the JAX package's registry that the port has not ported, by
# the title of their ROADMAP Queue 1 item (beside the zoo's).
UNPORTED_FAMILIES: dict = {}
ZOO_ITEM = "Dormant LAVIS zoo"
ZOO_FAMILIES = (
    "alpro_qa", "alpro_retrieval", "blip2", "blip2_feature_extractor",
    "blip2_image_text_matching", "blip2_opt", "blip2_t5", "gpt_dialogue",
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


VIDEO_FAMILIES = ("blip2_mr", "blip2_opt_mr", "blip2_fmr", "alpro", "gpt_dialogue",
                  "timesformer")


def load_model_and_preprocess(name, model_type=None, is_eval=False, device="cuda",
                              **kwargs):
    """(model, vis_processors, txt_processors) as the reference returns them,
    per family as the JAX package resolves them: the video families get the
    video processors at the model's image size (the MR families emitting
    uint8 frames, ``normalize=False``: the model normalizes on the device),
    the image families the still-image ones (``blip_image_train`` /
    ``blip_image_eval``, CLIP-normalized fp32); the text processors are
    ``blip_caption`` for training and ``blip_question`` for evaluation."""
    from mr_blip_tpu_torch.processors.text_processors import (
        BlipCaptionProcessor,
        BlipQuestionProcessor,
    )

    model = load_model(name, model_type=model_type, is_eval=is_eval, device=device,
                       **kwargs)
    img = getattr(model, "img_size", 224)
    if img == 224 and hasattr(model, "config"):  # a ResNet tower's own size, as JAX reads it
        resnet_cfg = getattr(model.config, "resnet", None)
        if resnet_cfg is not None:
            img = resnet_cfg.image_size
        else:
            img = getattr(getattr(model.config, "vision", None), "img_size", img)
    if any(name.startswith(f) for f in VIDEO_FAMILIES):
        from mr_blip_tpu_torch.processors.video_processors import (
            Blip2VideoTrainProcessor,
            BlipVideoEvalProcessor,
        )

        uint8_ok = name.startswith(("blip2_mr", "blip2_opt_mr", "blip2_fmr"))
        vis_processors = {
            "train": Blip2VideoTrainProcessor(image_size=img, normalize=not uint8_ok),
            "eval": BlipVideoEvalProcessor(image_size=img, normalize=not uint8_ok),
        }
    else:
        from mr_blip_tpu_torch.processors.image_processors import (
            BlipImageEvalProcessor,
            BlipImageTrainProcessor,
        )

        vis_processors = {"train": BlipImageTrainProcessor(image_size=img),
                          "eval": BlipImageEvalProcessor(image_size=img)}
    txt_processors = {"train": BlipCaptionProcessor(), "eval": BlipQuestionProcessor()}
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
