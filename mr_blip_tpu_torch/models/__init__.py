"""The BLIP2-MR float generate and train paths: EVA ViT-g, Q-Former, Flan-T5,
and the decoder-only variant over OPT."""
