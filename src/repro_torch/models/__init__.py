from repro_torch.models.transformer import ModelDef, build
