from .basis import basis_matrix
from .envelope import Channel, ChannelEnvelope, SimpleEnvelope
