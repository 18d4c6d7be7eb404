"""The BLIP2-MR float generate and train paths: EVA ViT-g, Q-Former, Flan-T5."""
