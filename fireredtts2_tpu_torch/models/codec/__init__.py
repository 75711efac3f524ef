"""RedCodec: encode, batch decode and the streaming vocoder."""

from fireredtts2_tpu_torch.models.codec.decoder import (  # noqa: F401
    stream_decode_chunk,
)
from fireredtts2_tpu_torch.models.codec.model import (  # noqa: F401
    codec_decode,
    codec_encode,
    init_codec_params,
    stream_decode_init,
    stream_decode_step,
)
