"""The WebP container: RIFF chunks, the VP8X extended format's demuxer
(`demux.WebPDecoder`) and animation compositing, host-side."""
