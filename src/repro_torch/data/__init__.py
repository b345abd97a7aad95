from .pipeline import Pipeline, Stage, SyntheticLM

__all__ = ["Pipeline", "Stage", "SyntheticLM"]
