"""Training models of the port."""

from .ood_model import OODFaceGANModel
