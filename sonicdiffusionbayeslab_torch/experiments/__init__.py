from sonicdiffusionbayeslab_torch.experiments.base import BaseMethod  # noqa: F401
from sonicdiffusionbayeslab_torch.experiments.methods import DPMSolverMethod  # noqa: F401
