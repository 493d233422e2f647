"""Native host-side components (counterpart of echo_tts_tpu/native): the
upfirdn resampler (`resample.cc`, built with g++ at first use by
`build.py`) and MP3 decode/encode on the system libmpg123 / libmp3lame
(`mp3_py.py`). Host work: nothing here touches the device."""
