"""The BLIP2-MR float generate path: EVA ViT-g, Q-Former, Flan-T5."""
