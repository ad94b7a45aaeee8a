"""Multibody models (counterpart of tds_tpu.model): joints, the static
model and MultiBodyBuilder, geometry, the pendulum constructors."""

from tds_tpu_torch.model.joints import JointType
from tds_tpu_torch.model.multibody import MultiBodyBuilder, MultiBodyModel, MultiBodyState
