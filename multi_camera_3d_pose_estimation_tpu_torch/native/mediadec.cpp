// Media runtime of the port: libav demux/decode with a threaded prefetch
// ring, a multi-camera block assembler, container audio decode and an
// audio remux.  Host code (no kernel): a copy of the JAX package's
// native/mediadec.cpp, so that the port decodes the same frames and the
// same samples bit for bit.  Exposed as a plain C ABI for ctypes
// (`native/__init__.py`).
//
// Build (native/__init__.py::build does it into the package's build/):
//   make -C native OUT=<path>/libmediadec.so

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libavutil/opt.h>
#include <libswresample/swresample.h>
#include <libswscale/swscale.h>
}

#include <atomic>
#include <condition_variable>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct VideoHandle {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* dec = nullptr;
  SwsContext* sws = nullptr;
  AVPacket* pkt = nullptr;
  AVFrame* frame = nullptr;
  int stream_index = -1;
  int width = 0, height = 0;
  double fps = 0.0;
  int64_t nframes = -1;  // container estimate; -1 unknown
  bool eof = false;
  std::string error;

  // Prefetch state.
  std::thread worker;
  std::mutex mu;
  std::condition_variable cv_full, cv_empty;
  std::deque<std::vector<uint8_t>> ready;  // decoded RGB frames
  size_t ring_capacity = 0;
  std::atomic<bool> stop{false};
  bool prefetching = false;
};

bool decode_next_into(VideoHandle* h, uint8_t* rgb_out) {
  // Returns false at EOF/error. rgb_out: H*W*3 bytes.
  while (true) {
    int ret = avcodec_receive_frame(h->dec, h->frame);
    if (ret == 0) {
      uint8_t* dst[1] = {rgb_out};
      int dst_linesize[1] = {3 * h->width};
      sws_scale(h->sws, h->frame->data, h->frame->linesize, 0, h->height, dst,
                dst_linesize);
      av_frame_unref(h->frame);
      return true;
    }
    if (ret == AVERROR_EOF) return false;
    if (ret != AVERROR(EAGAIN)) return false;
    // Need more input.
    while (true) {
      ret = av_read_frame(h->fmt, h->pkt);
      if (ret < 0) {
        // Flush.
        avcodec_send_packet(h->dec, nullptr);
        break;
      }
      if (h->pkt->stream_index == h->stream_index) {
        avcodec_send_packet(h->dec, h->pkt);
        av_packet_unref(h->pkt);
        break;
      }
      av_packet_unref(h->pkt);
    }
  }
}

void prefetch_loop(VideoHandle* h) {
  const size_t frame_bytes = size_t(h->width) * h->height * 3;
  while (!h->stop.load()) {
    std::vector<uint8_t> buf(frame_bytes);
    if (!decode_next_into(h, buf.data())) {
      std::lock_guard<std::mutex> lk(h->mu);
      h->eof = true;
      h->cv_empty.notify_all();
      return;
    }
    std::unique_lock<std::mutex> lk(h->mu);
    h->cv_full.wait(
        lk, [h] { return h->ready.size() < h->ring_capacity || h->stop.load(); });
    if (h->stop.load()) return;
    h->ready.emplace_back(std::move(buf));
    h->cv_empty.notify_all();
  }
}

// Multi-camera block assembler (VERDICT r4 #1): one persistent worker
// thread per camera decodes straight into its slice of the caller's
// preallocated (B, C, H, W, 3) uint8 block — sws_scale's RGB output lands
// at its final strided address, so block assembly costs ZERO extra copies
// and runs outside the Python GIL.  (The previous path decoded into a
// per-frame ring, memcpy'd ring→per-camera buffer, then Python-copied
// per-camera→block serially — measured 560 fps on a 1-core host vs
// 2864 fps device compute, PROFILE.md round 4.)
struct Assembler {
  std::vector<VideoHandle*> cams;
  int n_cams = 0, width = 0, height = 0;
  size_t frame_bytes = 0;

  std::mutex mu;
  std::condition_variable cv_job, cv_done;
  uint64_t job_seq = 0;
  unsigned char* job_out = nullptr;
  int job_max = 0;
  size_t job_stride = 0;  // bytes between frame t and t+1 for one camera
  std::vector<int> got;
  int done_count = 0;
  bool stop = false;
  std::vector<std::thread> workers;
};

void assembler_worker(Assembler* a, int c) {
  uint64_t seen = 0;
  while (true) {
    unsigned char* base;
    int maxf;
    size_t stride;
    {
      std::unique_lock<std::mutex> lk(a->mu);
      a->cv_job.wait(lk, [&] { return a->stop || a->job_seq != seen; });
      if (a->stop) return;
      seen = a->job_seq;
      base = a->job_out + size_t(c) * a->frame_bytes;
      maxf = a->job_max;
      stride = a->job_stride;
    }
    int n = 0;
    while (n < maxf && decode_next_into(a->cams[c], base + size_t(n) * stride))
      ++n;
    {
      std::lock_guard<std::mutex> lk(a->mu);
      a->got[c] = n;
      if (++a->done_count == a->n_cams) a->cv_done.notify_all();
    }
  }
}

}  // namespace

extern "C" {

// Open n_cams videos as one block assembler.  All videos must share one
// frame geometry.  Returns nullptr on any failure.
void* md_open(const char* path);  // fwd decl for mda_open
void md_close(void* vh);

void* mda_open(const char** paths, int n_cams) {
  if (n_cams < 1) return nullptr;
  auto* a = new Assembler();
  for (int c = 0; c < n_cams; ++c) {
    auto* vh = static_cast<VideoHandle*>(md_open(paths[c]));
    if (!vh) {
      for (auto* p : a->cams) md_close(p);
      delete a;
      return nullptr;
    }
    a->cams.push_back(vh);
  }
  a->n_cams = n_cams;
  a->width = a->cams[0]->width;
  a->height = a->cams[0]->height;
  for (auto* vh : a->cams) {
    if (vh->width != a->width || vh->height != a->height) {
      for (auto* p : a->cams) md_close(p);
      delete a;
      return nullptr;
    }
  }
  a->frame_bytes = size_t(a->width) * a->height * 3;
  a->got.assign(n_cams, 0);
  for (int c = 0; c < n_cams; ++c)
    a->workers.emplace_back(assembler_worker, a, c);
  return a;
}

void mda_info(void* va, int* w, int* hgt, double* fps, long long* nframes) {
  auto* a = static_cast<Assembler*>(va);
  *w = a->width;
  *hgt = a->height;
  *fps = a->cams[0]->fps;
  long long nf = -1;
  for (auto* vh : a->cams) {
    if (vh->nframes >= 0 && (nf < 0 || vh->nframes < nf)) nf = vh->nframes;
  }
  *nframes = nf;
}

// Fill `out` = (max_frames, n_cams, H, W, 3) uint8 with the next block.
// Every camera decodes its slice concurrently; returns min over cameras of
// frames decoded (0 = EOF).  Rows beyond the returned count are NOT
// zeroed (the caller pads its final partial block once).
int mda_next_block(void* va, unsigned char* out, int max_frames) {
  auto* a = static_cast<Assembler*>(va);
  std::unique_lock<std::mutex> lk(a->mu);
  a->job_out = out;
  a->job_max = max_frames;
  a->job_stride = size_t(a->n_cams) * a->frame_bytes;
  a->done_count = 0;
  ++a->job_seq;
  a->cv_job.notify_all();
  a->cv_done.wait(lk, [a] { return a->done_count == a->n_cams; });
  int n = max_frames;
  for (int c = 0; c < a->n_cams; ++c)
    if (a->got[c] < n) n = a->got[c];
  return n;
}

void mda_close(void* va) {
  auto* a = static_cast<Assembler*>(va);
  {
    std::lock_guard<std::mutex> lk(a->mu);
    a->stop = true;
    a->cv_job.notify_all();
  }
  for (auto& t : a->workers)
    if (t.joinable()) t.join();
  for (auto* vh : a->cams) md_close(vh);
  delete a;
}

void* md_open(const char* path) {
  auto* h = new VideoHandle();
  if (avformat_open_input(&h->fmt, path, nullptr, nullptr) < 0) {
    delete h;
    return nullptr;
  }
  if (avformat_find_stream_info(h->fmt, nullptr) < 0) {
    avformat_close_input(&h->fmt);
    delete h;
    return nullptr;
  }
  const AVCodec* codec = nullptr;
  h->stream_index =
      av_find_best_stream(h->fmt, AVMEDIA_TYPE_VIDEO, -1, -1, &codec, 0);
  if (h->stream_index < 0 || !codec) {
    avformat_close_input(&h->fmt);
    delete h;
    return nullptr;
  }
  AVStream* st = h->fmt->streams[h->stream_index];
  h->dec = avcodec_alloc_context3(codec);
  avcodec_parameters_to_context(h->dec, st->codecpar);
  h->dec->thread_count = 0;  // auto
  if (avcodec_open2(h->dec, codec, nullptr) < 0) {
    avcodec_free_context(&h->dec);
    avformat_close_input(&h->fmt);
    delete h;
    return nullptr;
  }
  h->width = h->dec->width;
  h->height = h->dec->height;
  AVRational fr = av_guess_frame_rate(h->fmt, st, nullptr);
  h->fps = fr.den ? double(fr.num) / fr.den : 0.0;
  h->nframes = st->nb_frames > 0 ? st->nb_frames : -1;
  h->sws = sws_getContext(h->width, h->height, h->dec->pix_fmt, h->width,
                          h->height, AV_PIX_FMT_RGB24, SWS_BILINEAR, nullptr,
                          nullptr, nullptr);
  h->pkt = av_packet_alloc();
  h->frame = av_frame_alloc();
  return h;
}

void md_info(void* vh, int* w, int* hgt, double* fps, long long* nframes) {
  auto* h = static_cast<VideoHandle*>(vh);
  *w = h->width;
  *hgt = h->height;
  *fps = h->fps;
  *nframes = h->nframes;
}

// Synchronous read of up to max_frames RGB24 frames into out. Returns count.
int md_read_frames(void* vh, unsigned char* out, int max_frames) {
  auto* h = static_cast<VideoHandle*>(vh);
  const size_t frame_bytes = size_t(h->width) * h->height * 3;
  int n = 0;
  while (n < max_frames) {
    if (!decode_next_into(h, out + size_t(n) * frame_bytes)) break;
    ++n;
  }
  return n;
}

// Start background prefetch with a ring of `capacity` decoded frames.
void md_start_prefetch(void* vh, int capacity) {
  auto* h = static_cast<VideoHandle*>(vh);
  if (h->prefetching) return;
  h->ring_capacity = capacity > 0 ? size_t(capacity) : 8;
  h->stop.store(false);
  h->prefetching = true;
  h->worker = std::thread(prefetch_loop, h);
}

// Pop up to max_frames prefetched frames (blocks until ≥1 or EOF). Returns
// count (0 = EOF).
int md_next_frames(void* vh, unsigned char* out, int max_frames) {
  auto* h = static_cast<VideoHandle*>(vh);
  const size_t frame_bytes = size_t(h->width) * h->height * 3;
  std::unique_lock<std::mutex> lk(h->mu);
  h->cv_empty.wait(lk, [h] { return !h->ready.empty() || h->eof; });
  int n = 0;
  while (n < max_frames && !h->ready.empty()) {
    std::memcpy(out + size_t(n) * frame_bytes, h->ready.front().data(),
                frame_bytes);
    h->ready.pop_front();
    ++n;
  }
  h->cv_full.notify_all();
  return n;
}

void md_close(void* vh) {
  auto* h = static_cast<VideoHandle*>(vh);
  if (h->prefetching) {
    h->stop.store(true);
    h->cv_full.notify_all();
    h->cv_empty.notify_all();
    if (h->worker.joinable()) h->worker.join();
  }
  if (h->sws) sws_freeContext(h->sws);
  if (h->frame) av_frame_free(&h->frame);
  if (h->pkt) av_packet_free(&h->pkt);
  if (h->dec) avcodec_free_context(&h->dec);
  if (h->fmt) avformat_close_input(&h->fmt);
  delete h;
}

// Decode the first audio stream to mono float PCM at its native rate.
// Fills out[0..max_samples); returns samples written (≥0) or -1 on error.
// *sample_rate receives the stream rate.
long long md_read_audio(const char* path, float* out, long long max_samples,
                        int* sample_rate) {
  AVFormatContext* fmt = nullptr;
  if (avformat_open_input(&fmt, path, nullptr, nullptr) < 0) return -1;
  if (avformat_find_stream_info(fmt, nullptr) < 0) {
    avformat_close_input(&fmt);
    return -1;
  }
  const AVCodec* codec = nullptr;
  int si = av_find_best_stream(fmt, AVMEDIA_TYPE_AUDIO, -1, -1, &codec, 0);
  if (si < 0 || !codec) {
    avformat_close_input(&fmt);
    return -1;
  }
  AVStream* st = fmt->streams[si];
  AVCodecContext* dec = avcodec_alloc_context3(codec);
  avcodec_parameters_to_context(dec, st->codecpar);
  if (avcodec_open2(dec, codec, nullptr) < 0) {
    avcodec_free_context(&dec);
    avformat_close_input(&fmt);
    return -1;
  }
  *sample_rate = dec->sample_rate;

  SwrContext* swr = nullptr;
  AVChannelLayout mono = AV_CHANNEL_LAYOUT_MONO;
  swr_alloc_set_opts2(&swr, &mono, AV_SAMPLE_FMT_FLT, dec->sample_rate,
                      &dec->ch_layout, dec->sample_fmt, dec->sample_rate, 0,
                      nullptr);
  swr_init(swr);

  AVPacket* pkt = av_packet_alloc();
  AVFrame* frame = av_frame_alloc();
  long long written = 0;
  bool flushed = false;
  while (written < max_samples) {
    int ret = avcodec_receive_frame(dec, frame);
    if (ret == 0) {
      uint8_t* outp[1] = {reinterpret_cast<uint8_t*>(out + written)};
      int space = int(max_samples - written);
      int got = swr_convert(swr, outp, space,
                            const_cast<const uint8_t**>(frame->data),
                            frame->nb_samples);
      if (got > 0) written += got;
      av_frame_unref(frame);
      continue;
    }
    if (ret == AVERROR_EOF) break;
    if (ret != AVERROR(EAGAIN)) break;
    if (flushed) break;
    while (true) {
      ret = av_read_frame(fmt, pkt);
      if (ret < 0) {
        avcodec_send_packet(dec, nullptr);
        flushed = true;
        break;
      }
      if (pkt->stream_index == si) {
        avcodec_send_packet(dec, pkt);
        av_packet_unref(pkt);
        break;
      }
      av_packet_unref(pkt);
    }
  }
  av_frame_free(&frame);
  av_packet_free(&pkt);
  swr_free(&swr);
  avcodec_free_context(&dec);
  avformat_close_input(&fmt);
  return written;
}

// Remux a video file into `out_path` (container chosen by extension, e.g.
// .mov/.mp4) adding a mono pcm_s16le audio track built from `samples`
// (float in [-1, 1]) at `sample_rate`.  Video packets are STREAM-COPIED
// (no video encoder needed); PCM "encoding" is a byte repack that every
// libavcodec build ships.  Purpose: synthesize audio-bearing containers
// for the audio-sync path (reference synchronize_videos.py:203 extracts
// audio from the recorded .movs) in environments with no full encoder —
// closes the PARITY "audio decode coverage" gap with a real in-container
// fixture.  Returns 0 on success, negative on error.
int md_remux_with_audio(const char* video_in, const char* out_path,
                        const float* samples, long long n_samples,
                        int sample_rate) {
  AVFormatContext* in_fmt = nullptr;
  if (avformat_open_input(&in_fmt, video_in, nullptr, nullptr) < 0) return -1;
  if (avformat_find_stream_info(in_fmt, nullptr) < 0) {
    avformat_close_input(&in_fmt);
    return -2;
  }
  int vsi = av_find_best_stream(in_fmt, AVMEDIA_TYPE_VIDEO, -1, -1, nullptr, 0);
  if (vsi < 0) {
    avformat_close_input(&in_fmt);
    return -3;
  }

  AVFormatContext* out_fmt = nullptr;
  if (avformat_alloc_output_context2(&out_fmt, nullptr, nullptr, out_path) < 0 ||
      !out_fmt) {
    avformat_close_input(&in_fmt);
    return -4;
  }

  // Video: stream copy.
  AVStream* v_out = avformat_new_stream(out_fmt, nullptr);
  avcodec_parameters_copy(v_out->codecpar, in_fmt->streams[vsi]->codecpar);
  v_out->codecpar->codec_tag = 0;
  v_out->time_base = in_fmt->streams[vsi]->time_base;

  // Audio: trivial PCM encoder.
  const AVCodec* pcm = avcodec_find_encoder(AV_CODEC_ID_PCM_S16LE);
  int rc = 0;
  AVCodecContext* enc = nullptr;
  AVStream* a_out = nullptr;
  if (!pcm) {
    rc = -5;
  } else {
    enc = avcodec_alloc_context3(pcm);
    enc->sample_rate = sample_rate;
    enc->sample_fmt = AV_SAMPLE_FMT_S16;
    AVChannelLayout mono = AV_CHANNEL_LAYOUT_MONO;
    av_channel_layout_copy(&enc->ch_layout, &mono);
    enc->time_base = AVRational{1, sample_rate};
    if (avcodec_open2(enc, pcm, nullptr) < 0) rc = -6;
    if (rc == 0) {
      a_out = avformat_new_stream(out_fmt, nullptr);
      avcodec_parameters_from_context(a_out->codecpar, enc);
      a_out->time_base = enc->time_base;
    }
  }

  if (rc == 0 && !(out_fmt->oformat->flags & AVFMT_NOFILE) &&
      avio_open(&out_fmt->pb, out_path, AVIO_FLAG_WRITE) < 0) {
    rc = -7;
  }
  if (rc == 0 && avformat_write_header(out_fmt, nullptr) < 0) rc = -8;

  AVPacket* pkt = av_packet_alloc();
  // Copy every video packet (fixtures are short: interleaving buffers are
  // fine with audio written afterwards).
  while (rc == 0 && av_read_frame(in_fmt, pkt) >= 0) {
    if (pkt->stream_index == vsi) {
      av_packet_rescale_ts(pkt, in_fmt->streams[vsi]->time_base,
                           v_out->time_base);
      pkt->stream_index = v_out->index;
      if (av_interleaved_write_frame(out_fmt, pkt) < 0) rc = -9;
    }
    av_packet_unref(pkt);
  }

  // Feed PCM in frame-sized chunks.
  if (rc == 0) {
    const int chunk = 1024;
    AVFrame* af = av_frame_alloc();
    long long pos = 0;
    while (rc == 0 && pos < n_samples) {
      int n = int(n_samples - pos < chunk ? n_samples - pos : chunk);
      af->nb_samples = n;
      af->format = AV_SAMPLE_FMT_S16;
      AVChannelLayout mono = AV_CHANNEL_LAYOUT_MONO;
      av_channel_layout_copy(&af->ch_layout, &mono);
      af->sample_rate = sample_rate;
      if (av_frame_get_buffer(af, 0) < 0) {
        rc = -10;
        break;
      }
      auto* dst = reinterpret_cast<int16_t*>(af->data[0]);
      for (int i = 0; i < n; ++i) {
        float v = samples[pos + i];
        if (v > 1.f) v = 1.f;
        if (v < -1.f) v = -1.f;
        dst[i] = int16_t(v * 32767.f);
      }
      af->pts = pos;
      if (avcodec_send_frame(enc, af) < 0) rc = -11;
      AVPacket* apkt = av_packet_alloc();
      while (rc == 0 && avcodec_receive_packet(enc, apkt) == 0) {
        av_packet_rescale_ts(apkt, enc->time_base, a_out->time_base);
        apkt->stream_index = a_out->index;
        if (av_interleaved_write_frame(out_fmt, apkt) < 0) rc = -12;
        av_packet_unref(apkt);
      }
      av_packet_free(&apkt);
      av_frame_unref(af);
      pos += n;
    }
    // Flush the (stateless) PCM encoder for form's sake.
    if (rc == 0) {
      avcodec_send_frame(enc, nullptr);
      AVPacket* apkt = av_packet_alloc();
      while (avcodec_receive_packet(enc, apkt) == 0) {
        av_packet_rescale_ts(apkt, enc->time_base, a_out->time_base);
        apkt->stream_index = a_out->index;
        av_interleaved_write_frame(out_fmt, apkt);
        av_packet_unref(apkt);
      }
      av_packet_free(&apkt);
    }
    av_frame_free(&af);
  }

  if (rc == 0) av_write_trailer(out_fmt);
  av_packet_free(&pkt);
  if (enc) avcodec_free_context(&enc);
  if (out_fmt) {
    if (!(out_fmt->oformat->flags & AVFMT_NOFILE) && out_fmt->pb)
      avio_closep(&out_fmt->pb);
    avformat_free_context(out_fmt);
  }
  avformat_close_input(&in_fmt);
  return rc;
}

}  // extern "C"
