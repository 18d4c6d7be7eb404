// Native video decode library (FFmpeg/libav) — the framework's replacement
// for decord (reference lavis/datasets/data_utils.py:30-85 uses decord's
// VideoReader for random-access frame gathers) and PyAV (window re-decode,
// lavis/models/blip2_mr_models/utils.py:532-606).
//
// C API (ctypes-friendly):
//   vd_open(path, out_w, out_h)       -> handle (scaled RGB24 output)
//   vd_info(h, &fps, &nframes, &dur)  -> 0 on success
//   vd_get_batch(h, indices, n, out)  -> decode specific frame indices
//   vd_get_window(h, t0, t1, max_n, out, &n_out) -> all frames in [t0, t1) s
//   vd_close(h)
//   vd_write_test_video(path, w, h, n_frames, fps) -> encode a synthetic
//       MPEG4/AVI clip (deterministic per-frame pattern) for hermetic tests.
//
// Random access: frame index -> PTS via average frame rate; seek to the
// keyframe at/before the target, then decode forward. Batches are served
// in sorted order so each monotone run reuses the decode position.

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libavutil/opt.h>
#include <libswscale/swscale.h>
}

#include <sys/stat.h>

#include <algorithm>
#include <condition_variable>
#include <cstring>
#include <deque>
#include <mutex>
#include <numeric>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct VideoHandle {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* codec = nullptr;
  SwsContext* sws = nullptr;
  AVFrame* frame = nullptr;
  AVFrame* rgb = nullptr;
  AVPacket* pkt = nullptr;
  int stream_index = -1;
  int out_w = 0, out_h = 0;
  double fps = 0.0;
  int64_t nframes = 0;
  double duration = 0.0;
  int64_t cur_frame = -1;  // index of the last frame decoded
  // Exact frame-index -> pts table (sorted), built by a demux-only scan at
  // open. Empty => fall back to the avg-fps arithmetic mapping.
  std::vector<int64_t> pts_map;
  // Seek-point (keyframe packet) pts, sorted — the subset of pts_map whose
  // packets carried AV_PKT_FLAG_KEY. Lets the batch decoder decide EXACTLY
  // when a seek skips decode work: if the last keyframe at/before the
  // target is ahead of the current position, seeking jumps over every
  // intermediate frame of the current GOP run instead of decoding through
  // it (the old heuristic decoded up to 4*fps frames per gap).
  std::vector<int64_t> key_pts;
};

// ------------------------------------------------------------- pts-map cache
// The async pool and the eval loaders reopen the same clip many times (one
// handle per in-flight job); the demux scan is per-open latency that is
// identical every time. Cache (path, size, mtime) -> (pts_map, key_pts),
// bounded FIFO. (ADVICE r4: "consider caching the map per path".)

struct PtsMapEntry {
  std::vector<int64_t> pts;
  std::vector<int64_t> keys;
};

std::mutex g_pts_cache_mu;
std::unordered_map<std::string, PtsMapEntry> g_pts_cache;
std::deque<std::string> g_pts_cache_order;
constexpr size_t kPtsCacheCap = 256;

std::string pts_cache_key(const char* path) {
  struct stat st;
  if (stat(path, &st) != 0) return {};
  return std::string(path) + "|" + std::to_string((long long)st.st_size) +
         "|" + std::to_string((long long)st.st_mtime);
}

double stream_fps(AVStream* st) {
  AVRational r = st->avg_frame_rate;
  if (r.num == 0 || r.den == 0) r = st->r_frame_rate;
  if (r.num == 0 || r.den == 0) return 0.0;
  return av_q2d(r);
}

int64_t index_to_pts(VideoHandle* h, int64_t index) {
  if (!h->pts_map.empty()) {
    if (index < 0) index = 0;
    if (index >= (int64_t)h->pts_map.size())
      index = (int64_t)h->pts_map.size() - 1;
    return h->pts_map[index];
  }
  AVStream* st = h->fmt->streams[h->stream_index];
  double t = index / h->fps;  // seconds
  return (int64_t)(t / av_q2d(st->time_base) + 0.5) + (
      st->start_time == AV_NOPTS_VALUE ? 0 : st->start_time);
}

int64_t pts_to_index(VideoHandle* h, int64_t pts) {
  if (!h->pts_map.empty()) {
    // Last map entry <= pts: exact on clean streams, and robust to the
    // small timestamp jitter best_effort_timestamp can carry.
    auto it = std::upper_bound(h->pts_map.begin(), h->pts_map.end(), pts);
    if (it == h->pts_map.begin()) return 0;
    return (int64_t)(it - h->pts_map.begin()) - 1;
  }
  AVStream* st = h->fmt->streams[h->stream_index];
  int64_t start = st->start_time == AV_NOPTS_VALUE ? 0 : st->start_time;
  double t = (pts - start) * av_q2d(st->time_base);
  return (int64_t)(t * h->fps + 0.5);
}

// Frame index -> presentation time (seconds) and the inverse, for the
// window API. Exact when the pts map exists.
double index_to_time(VideoHandle* h, int64_t index) {
  if (!h->pts_map.empty()) {
    AVStream* st = h->fmt->streams[h->stream_index];
    int64_t start = st->start_time == AV_NOPTS_VALUE ? 0 : st->start_time;
    if (index < 0) index = 0;
    if (index >= (int64_t)h->pts_map.size())
      index = (int64_t)h->pts_map.size() - 1;
    return (h->pts_map[index] - start) * av_q2d(st->time_base);
  }
  return index / h->fps;
}

int64_t time_to_index(VideoHandle* h, double t) {
  if (!h->pts_map.empty()) {
    AVStream* st = h->fmt->streams[h->stream_index];
    int64_t start = st->start_time == AV_NOPTS_VALUE ? 0 : st->start_time;
    return pts_to_index(h, (int64_t)(t / av_q2d(st->time_base)) + start);
  }
  return (int64_t)(t * h->fps);
}

// Build the exact frame-index -> pts table by demuxing (NOT decoding) the
// stream once. decord builds the same map, and for the same reason:
// web-sourced video (QVH is YouTube material) is often slightly VFR or
// carries imprecise container fps metadata, and deriving frame indices as
// round(pts * avg_fps) then mis-selects frames. Observed concretely: an
// mp4 whose demuxer-computed avg fps was 1200/119 instead of 10 shifted
// every decoded frame past #60 by one. Demux-only costs ~us/packet (a
// 150 s QVH clip is ~4.5k packets); codec state is untouched.
// The map assumes one displayed frame per demuxed packet. That holds for
// the codecs video datasets actually ship (H.264/HEVC/MPEG-4/2/1, MJPEG,
// VP8) but NOT for VP9/AV1, whose alt-ref/hidden frames arrive as packets
// that display nothing — an uncorrectable over-count that would silently
// shift every frame index (ADVICE r4). For unsafe codecs the map is kept
// only when the container's own nb_frames confirms the packet count.
bool pts_map_codec_safe(AVCodecID id) {
  switch (id) {
    case AV_CODEC_ID_H264:
    case AV_CODEC_ID_HEVC:
    case AV_CODEC_ID_MPEG4:
    case AV_CODEC_ID_MPEG2VIDEO:
    case AV_CODEC_ID_MPEG1VIDEO:
    case AV_CODEC_ID_MJPEG:
    case AV_CODEC_ID_VP8:
      return true;
    default:
      return false;
  }
}

void build_pts_map(VideoHandle* h, const char* path) {
  const std::string ck = pts_cache_key(path);
  if (!ck.empty()) {
    std::lock_guard<std::mutex> lk(g_pts_cache_mu);
    auto it = g_pts_cache.find(ck);
    if (it != g_pts_cache.end()) {
      h->pts_map = it->second.pts;
      h->key_pts = it->second.keys;
      if (!h->pts_map.empty()) h->nframes = (int64_t)h->pts_map.size();
      return;  // demuxer is already at file start — no rewind needed
    }
  }
  AVPacket* pkt = av_packet_alloc();
  std::vector<int64_t> pts, keys;
  while (av_read_frame(h->fmt, pkt) >= 0) {
    if (pkt->stream_index == h->stream_index) {
      int64_t p = pkt->pts == AV_NOPTS_VALUE ? pkt->dts : pkt->pts;
      if (p != AV_NOPTS_VALUE) {
        pts.push_back(p);
        if (pkt->flags & AV_PKT_FLAG_KEY) keys.push_back(p);
      }
    }
    av_packet_unref(pkt);
  }
  av_packet_free(&pkt);
  std::sort(pts.begin(), pts.end());
  pts.erase(std::unique(pts.begin(), pts.end()), pts.end());
  std::sort(keys.begin(), keys.end());
  keys.erase(std::unique(keys.begin(), keys.end()), keys.end());

  AVStream* st = h->fmt->streams[h->stream_index];
  int64_t container_n = st->nb_frames;
  bool verified = container_n > 0 && (int64_t)pts.size() == container_n;
  bool keep = !pts.empty() &&
              (pts_map_codec_safe(st->codecpar->codec_id)
                   // safe codec: a disagreeing container count is a red
                   // flag (field-coded or broken stream) — drop to the
                   // fps-arithmetic fallback rather than index wrongly
                   ? (container_n <= 0 || verified)
                   // unsafe codec (VP9/AV1 alt-ref risk): keep only when
                   // the container confirms packet count == frame count
                   : verified);
  if (keep) {
    h->pts_map = std::move(pts);
    h->key_pts = std::move(keys);
    h->nframes = (int64_t)h->pts_map.size();
    if (!ck.empty()) {
      std::lock_guard<std::mutex> lk(g_pts_cache_mu);
      if (g_pts_cache.emplace(ck, PtsMapEntry{h->pts_map, h->key_pts})
              .second) {
        g_pts_cache_order.push_back(ck);
        while (g_pts_cache_order.size() > kPtsCacheCap) {
          g_pts_cache.erase(g_pts_cache_order.front());
          g_pts_cache_order.pop_front();
        }
      }
    }
  }
  // Rewind the demuxer for the decode phase.
  av_seek_frame(h->fmt, h->stream_index,
                h->pts_map.empty() ? 0 : h->pts_map.front(),
                AVSEEK_FLAG_BACKWARD);
}

// Decode the next frame into h->frame; returns frame index or -1 on EOF.
int64_t decode_next(VideoHandle* h) {
  while (true) {
    int ret = avcodec_receive_frame(h->codec, h->frame);
    if (ret == 0) {
      int64_t pts = h->frame->best_effort_timestamp;
      if (pts == AV_NOPTS_VALUE) pts = h->frame->pts;
      h->cur_frame =
          pts == AV_NOPTS_VALUE ? h->cur_frame + 1 : pts_to_index(h, pts);
      return h->cur_frame;
    }
    if (ret != AVERROR(EAGAIN)) return -1;
    // feed more packets
    while (true) {
      ret = av_read_frame(h->fmt, h->pkt);
      if (ret < 0) {
        avcodec_send_packet(h->codec, nullptr);  // flush
        break;
      }
      if (h->pkt->stream_index == h->stream_index) {
        avcodec_send_packet(h->codec, h->pkt);
        av_packet_unref(h->pkt);
        break;
      }
      av_packet_unref(h->pkt);
    }
  }
}

void scale_into(VideoHandle* h, unsigned char* dst) {
  uint8_t* dst_data[4] = {dst, nullptr, nullptr, nullptr};
  int dst_linesize[4] = {3 * h->out_w, 0, 0, 0};
  sws_scale(h->sws, h->frame->data, h->frame->linesize, 0, h->codec->height,
            dst_data, dst_linesize);
}

int seek_to_index(VideoHandle* h, int64_t index) {
  int64_t pts = index_to_pts(h, index);
  int ret = av_seek_frame(h->fmt, h->stream_index, pts, AVSEEK_FLAG_BACKWARD);
  if (ret < 0) return ret;
  avcodec_flush_buffers(h->codec);
  h->cur_frame = -1;
  return 0;
}

}  // namespace

extern "C" {

// flags bit 0: SWS_FAST_BILINEAR scaling instead of SWS_BICUBIC — an eval
// loader option (decode-bound hosts); quality gated by
// tests/test_video_decode.py::test_fast_scale_quality.
void* vd_open_ex(const char* path, int out_w, int out_h, int flags) {
  av_log_set_level(AV_LOG_ERROR);
  auto* h = new VideoHandle();
  if (avformat_open_input(&h->fmt, path, nullptr, nullptr) < 0) goto fail;
  if (avformat_find_stream_info(h->fmt, nullptr) < 0) goto fail;
  h->stream_index =
      av_find_best_stream(h->fmt, AVMEDIA_TYPE_VIDEO, -1, -1, nullptr, 0);
  if (h->stream_index < 0) goto fail;
  {
    AVStream* st = h->fmt->streams[h->stream_index];
    const AVCodec* dec = avcodec_find_decoder(st->codecpar->codec_id);
    if (!dec) goto fail;
    h->codec = avcodec_alloc_context3(dec);
    avcodec_parameters_to_context(h->codec, st->codecpar);
    if (avcodec_open2(h->codec, dec, nullptr) < 0) goto fail;

    h->fps = stream_fps(st);
    if (h->fps <= 0) h->fps = 30.0;
    h->duration = (h->fmt->duration != AV_NOPTS_VALUE)
                      ? h->fmt->duration / (double)AV_TIME_BASE
                      : 0.0;
    h->nframes = st->nb_frames;
    if (h->nframes <= 0) h->nframes = (int64_t)(h->duration * h->fps + 0.5);
    if (h->nframes <= 0) h->nframes = 1;

    h->out_w = out_w > 0 ? out_w : h->codec->width;
    h->out_h = out_h > 0 ? out_h : h->codec->height;
    h->sws = sws_getContext(h->codec->width, h->codec->height,
                            h->codec->pix_fmt, h->out_w, h->out_h,
                            AV_PIX_FMT_RGB24,
                            (flags & 1) ? SWS_FAST_BILINEAR : SWS_BICUBIC,
                            nullptr, nullptr, nullptr);
    if (!h->sws) goto fail;
    h->frame = av_frame_alloc();
    h->rgb = av_frame_alloc();
    h->pkt = av_packet_alloc();
    build_pts_map(h, path);
  }
  return h;
fail:
  if (h->fmt) avformat_close_input(&h->fmt);
  delete h;
  return nullptr;
}

void* vd_open(const char* path, int out_w, int out_h) {
  return vd_open_ex(path, out_w, out_h, 0);
}

// Test/introspection hooks for the pts-map cache.
long long vd_pts_cache_size() {
  std::lock_guard<std::mutex> lk(g_pts_cache_mu);
  return (long long)g_pts_cache.size();
}

void vd_pts_cache_clear() {
  std::lock_guard<std::mutex> lk(g_pts_cache_mu);
  g_pts_cache.clear();
  g_pts_cache_order.clear();
}

// Whether a handle runs on the exact demux-built pts map (vs the avg-fps
// arithmetic fallback) and how many seek points it knows — lets tests
// assert the gating decisions without peeking at internals.
int vd_has_pts_map(void* handle, long long* n_keyframes) {
  auto* h = (VideoHandle*)handle;
  if (!h) return -1;
  if (n_keyframes) *n_keyframes = (long long)h->key_pts.size();
  return h->pts_map.empty() ? 0 : 1;
}

int vd_info(void* handle, double* fps, long long* nframes, double* duration,
            int* width, int* height) {
  auto* h = (VideoHandle*)handle;
  if (!h) return -1;
  *fps = h->fps;
  *nframes = h->nframes;
  *duration = h->duration;
  *width = h->out_w;
  *height = h->out_h;
  return 0;
}

// Decode the given frame indices (any order) into out (n, out_h, out_w, 3).
int vd_get_batch(void* handle, const long long* indices, int n,
                 unsigned char* out) {
  auto* h = (VideoHandle*)handle;
  if (!h) return -1;
  size_t frame_bytes = (size_t)h->out_w * h->out_h * 3;

  // Serve in sorted order; duplicate indices reuse the decoded frame.
  std::vector<int> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::sort(order.begin(), order.end(),
            [&](int a, int b) { return indices[a] < indices[b]; });

  for (int k = 0; k < n; ++k) {
    int oi = order[k];
    int64_t target = std::min<int64_t>(indices[oi], h->nframes - 1);
    if (target < 0) target = 0;
    if (k > 0 && indices[order[k - 1]] == indices[oi]) {
      memcpy(out + (size_t)oi * frame_bytes,
             out + (size_t)order[k - 1] * frame_bytes, frame_bytes);
      continue;
    }
    // Seek backward when the target is behind; seek FORWARD exactly when
    // it skips decode work. With the keyframe map that decision is exact:
    // seek iff the last seek-point at/before the target lies ahead of the
    // current position (the seek then jumps over every intermediate frame
    // instead of decoding through them — at QVH eval stride ~75 frames
    // with GOP 60 this skips most of each gap; the old 4*fps heuristic
    // decoded through any gap under ~120 frames). Without the map, keep
    // the heuristic.
    bool need_seek = h->cur_frame < 0 || target < h->cur_frame;
    if (!need_seek && target > h->cur_frame) {
      if (!h->key_pts.empty() && !h->pts_map.empty()) {
        int64_t tpts =
            h->pts_map[std::min(target, (int64_t)h->pts_map.size() - 1)];
        auto it =
            std::upper_bound(h->key_pts.begin(), h->key_pts.end(), tpts);
        if (it != h->key_pts.begin()) {
          // strictly more than one frame ahead: at +1 decode-through costs
          // the same as the seek and skips the flush/reprime
          need_seek = pts_to_index(h, *(it - 1)) > h->cur_frame + 1;
        }
      } else {
        need_seek = target > h->cur_frame + (int64_t)(4 * h->fps);
      }
    }
    if (need_seek && seek_to_index(h, target) < 0) return -2;
    int64_t got = h->cur_frame;
    int guard = 0;
    // Catch-up: while still far from the target, discard non-reference
    // frames (H.264/HEVC B-frames) without decoding them — they can never
    // affect later frames, so this is lossless for the target. The margin
    // must guarantee the TARGET's packet is fed with discard OFF: packets
    // arrive in decode order, which leads display order by at most the
    // stream's declared reorder depth (SPS max_num_reorder_frames =
    // codec->has_b_frames), so margin > has_b_frames suffices; +4 slack.
    // Streams that do not declare it fall back to the conservative 16.
    const int64_t kSkipMargin =
        h->codec->has_b_frames > 0 ? h->codec->has_b_frames + 4 : 16;
    while (got < target) {
      // Only engage once the decode position is KNOWN (got >= 0): right
      // after a seek cur_frame is -1, and treating that sentinel as
      // "far away" used to discard a non-ref TARGET sitting just past
      // its keyframe (returning the next frame instead).
      h->codec->skip_frame = (got >= 0 && target - got > kSkipMargin)
                                 ? AVDISCARD_NONREF
                                 : AVDISCARD_DEFAULT;
      got = decode_next(h);
      if (got < 0) break;  // EOF: keep last decoded frame
      if (++guard > 4096) break;
    }
    h->codec->skip_frame = AVDISCARD_DEFAULT;
    if (h->cur_frame < 0) {
      // Seek produced nothing (e.g. at EOF) — restart from 0.
      if (seek_to_index(h, 0) < 0) return -3;
      got = decode_next(h);
      if (got < 0) return -4;
      while (got < target) {
        int64_t nxt = decode_next(h);
        if (nxt < 0) break;
        got = nxt;
      }
    }
    scale_into(h, out + (size_t)oi * frame_bytes);
  }
  return 0;
}

// Decode every frame with t0 <= t < t1 (seconds), up to max_n frames.
int vd_get_window(void* handle, double t0, double t1, int max_n,
                  unsigned char* out, int* n_out) {
  auto* h = (VideoHandle*)handle;
  if (!h) return -1;
  if (t0 > t1) std::swap(t0, t1);
  size_t frame_bytes = (size_t)h->out_w * h->out_h * 3;
  int64_t first = time_to_index(h, t0);
  if (seek_to_index(h, first) < 0) return -2;
  int count = 0;
  while (count < max_n) {
    int64_t idx = decode_next(h);
    if (idx < 0) break;
    double t = index_to_time(h, idx);
    if (t < t0) continue;
    if (t >= t1) break;
    scale_into(h, out + (size_t)count * frame_bytes);
    ++count;
  }
  *n_out = count;
  return 0;
}

void vd_close(void* handle) {
  auto* h = (VideoHandle*)handle;
  if (!h) return;
  if (h->pkt) av_packet_free(&h->pkt);
  if (h->frame) av_frame_free(&h->frame);
  if (h->rgb) av_frame_free(&h->rgb);
  if (h->sws) sws_freeContext(h->sws);
  if (h->codec) avcodec_free_context(&h->codec);
  if (h->fmt) avformat_close_input(&h->fmt);
  delete h;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Asynchronous decode pool: N worker threads serving ticketed jobs so the
// host can decode ahead of (and concurrently with) device compute — the
// native analog of decord's internal thread pool. Used by the grounded-QA
// mid-inference window re-decode (reference blip2_mr.py:1167-1230 runs it
// serially per sample) and available to the data loaders.
//
// Contract: each opened handle has at most ONE job in flight (VideoHandle
// carries mutable decode state); callers own handles and output buffers,
// which must outlive the job until vpool_wait returns its ticket.
// ---------------------------------------------------------------------------

namespace {

struct PoolJob {
  void* handle = nullptr;
  std::vector<long long> indices;  // batch mode
  bool window_mode = false;
  double t0 = 0.0, t1 = 0.0;       // window mode
  int max_n = 0;
  int* n_out = nullptr;
  unsigned char* out = nullptr;
  long long ticket = 0;
};

struct DecodePool {
  std::vector<std::thread> workers;
  std::deque<PoolJob> jobs;
  std::mutex mu;
  std::condition_variable job_cv;
  std::condition_variable done_cv;
  std::unordered_map<long long, int> done;  // ticket -> status
  long long next_ticket = 1;
  bool stop = false;
};

void pool_worker(DecodePool* p) {
  for (;;) {
    PoolJob job;
    {
      std::unique_lock<std::mutex> lk(p->mu);
      p->job_cv.wait(lk, [&] { return p->stop || !p->jobs.empty(); });
      if (p->stop && p->jobs.empty()) return;
      job = std::move(p->jobs.front());
      p->jobs.pop_front();
    }
    int st;
    if (job.window_mode) {
      st = vd_get_window(job.handle, job.t0, job.t1, job.max_n, job.out,
                         job.n_out);
    } else {
      st = vd_get_batch(job.handle, job.indices.data(),
                        (int)job.indices.size(), job.out);
    }
    {
      std::lock_guard<std::mutex> lk(p->mu);
      p->done[job.ticket] = st;
    }
    p->done_cv.notify_all();
  }
}

long long enqueue(DecodePool* p, PoolJob&& job) {
  long long ticket;
  {
    std::lock_guard<std::mutex> lk(p->mu);
    ticket = p->next_ticket++;
    job.ticket = ticket;
    p->jobs.push_back(std::move(job));
  }
  p->job_cv.notify_one();
  return ticket;
}

}  // namespace

extern "C" {

void* vpool_create(int n_threads) {
  auto* p = new DecodePool();
  if (n_threads < 1) n_threads = 1;
  p->workers.reserve(n_threads);
  for (int i = 0; i < n_threads; ++i) p->workers.emplace_back(pool_worker, p);
  return p;
}

long long vpool_submit_batch(void* pool, void* handle,
                             const long long* indices, int n,
                             unsigned char* out) {
  auto* p = (DecodePool*)pool;
  if (!p || !handle || n < 0) return -1;
  PoolJob job;
  job.handle = handle;
  job.indices.assign(indices, indices + n);
  job.out = out;
  return enqueue(p, std::move(job));
}

long long vpool_submit_window(void* pool, void* handle, double t0, double t1,
                              int max_n, unsigned char* out, int* n_out) {
  auto* p = (DecodePool*)pool;
  if (!p || !handle) return -1;
  PoolJob job;
  job.handle = handle;
  job.window_mode = true;
  job.t0 = t0;
  job.t1 = t1;
  job.max_n = max_n;
  job.n_out = n_out;
  job.out = out;
  return enqueue(p, std::move(job));
}

// Blocks until the ticket's job completed; returns its decoder status and
// forgets the ticket. Unknown tickets return -100.
int vpool_wait(void* pool, long long ticket) {
  auto* p = (DecodePool*)pool;
  if (!p || ticket <= 0) return -100;
  std::unique_lock<std::mutex> lk(p->mu);
  p->done_cv.wait(lk, [&] { return p->done.count(ticket) > 0; });
  int st = p->done[ticket];
  p->done.erase(ticket);
  return st;
}

void vpool_destroy(void* pool) {
  auto* p = (DecodePool*)pool;
  if (!p) return;
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->stop = true;
  }
  p->job_cv.notify_all();
  for (auto& t : p->workers) t.join();
  delete p;
}

// Encode a deterministic synthetic clip so tests/benchmarks can exercise
// the real decode path hermetically.  Frame k has a moving gradient keyed
// to k.  `gop` controls keyframe spacing: benchmarks use realistic
// web-video GOPs (30-300) so random-access seeks pay the real
// decode-forward cost; tests keep the cheap default (8).  `codec_name`
// selects the encoder ("mpeg4" or "libx264"; H.264 with B-frames is what
// real QVH/Charades videos are) — the container is deduced from the path
// extension (.avi / .mp4).
int vd_write_test_video_codec(const char* path, int w, int h, int n_frames,
                              double fps, int gop, const char* codec_name) {
  const AVCodec* enc =
      codec_name && *codec_name
          ? avcodec_find_encoder_by_name(codec_name)
          : avcodec_find_encoder(AV_CODEC_ID_MPEG4);
  if (!enc) return -1;
  AVFormatContext* fmt = nullptr;
  avformat_alloc_output_context2(&fmt, nullptr, nullptr, path);
  if (!fmt) avformat_alloc_output_context2(&fmt, nullptr, "avi", path);
  if (!fmt) return -2;
  AVStream* st = avformat_new_stream(fmt, enc);
  AVCodecContext* ctx = avcodec_alloc_context3(enc);
  ctx->width = w;
  ctx->height = h;
  ctx->time_base = AVRational{1000, (int)(fps * 1000)};
  ctx->framerate = AVRational{(int)(fps * 1000), 1000};
  ctx->pix_fmt = AV_PIX_FMT_YUV420P;
  ctx->gop_size = gop > 0 ? gop : 8;
  ctx->bit_rate = 2000000;
  if (enc->id == AV_CODEC_ID_H264) {
    // Realistic web-video structure: B-frames on (the reason the decoder
    // has the AVDISCARD_NONREF catch-up path), fast deterministic encode.
    ctx->max_b_frames = 3;
    av_opt_set(ctx->priv_data, "preset", "veryfast", 0);
  }
  if (fmt->oformat->flags & AVFMT_GLOBALHEADER)
    ctx->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
  if (avcodec_open2(ctx, enc, nullptr) < 0) return -3;
  avcodec_parameters_from_context(st->codecpar, ctx);
  st->time_base = ctx->time_base;
  st->avg_frame_rate = ctx->framerate;
  if (!(fmt->oformat->flags & AVFMT_NOFILE))
    if (avio_open(&fmt->pb, path, AVIO_FLAG_WRITE) < 0) return -4;
  if (avformat_write_header(fmt, nullptr) < 0) return -5;

  AVFrame* fr = av_frame_alloc();
  fr->format = ctx->pix_fmt;
  fr->width = w;
  fr->height = h;
  av_frame_get_buffer(fr, 0);
  AVPacket* pkt = av_packet_alloc();

  auto flush = [&](AVFrame* f) {
    avcodec_send_frame(ctx, f);
    while (avcodec_receive_packet(ctx, pkt) == 0) {
      av_packet_rescale_ts(pkt, ctx->time_base, st->time_base);
      // Every sample carries its duration so the mp4 muxer's sample table
      // yields the exact fps at demux time (without this the last sample
      // gets duration 0 and the demuxer reports avg fps 1200/119 for a
      // 10 fps clip).
      pkt->duration = av_rescale_q(1, ctx->time_base, st->time_base);
      pkt->stream_index = st->index;
      av_interleaved_write_frame(fmt, pkt);
      av_packet_unref(pkt);
    }
  };

  for (int k = 0; k < n_frames; ++k) {
    av_frame_make_writable(fr);
    // Luma: gradient whose phase encodes the frame index.
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x)
        fr->data[0][y * fr->linesize[0] + x] =
            (uint8_t)((x * 3 + y + k * 16) & 0xFF);
    for (int y = 0; y < h / 2; ++y)
      for (int x = 0; x < w / 2; ++x) {
        fr->data[1][y * fr->linesize[1] + x] = (uint8_t)(64 + (k * 8 & 0x7F));
        fr->data[2][y * fr->linesize[2] + x] = (uint8_t)(128);
      }
    fr->pts = k;
    flush(fr);
  }
  flush(nullptr);
  av_write_trailer(fmt);
  av_packet_free(&pkt);
  av_frame_free(&fr);
  avcodec_free_context(&ctx);
  if (!(fmt->oformat->flags & AVFMT_NOFILE)) avio_closep(&fmt->pb);
  avformat_free_context(fmt);
  return 0;
}

int vd_write_test_video_gop(const char* path, int w, int h, int n_frames,
                            double fps, int gop) {
  return vd_write_test_video_codec(path, w, h, n_frames, fps, gop, "mpeg4");
}

int vd_write_test_video(const char* path, int w, int h, int n_frames,
                        double fps) {
  return vd_write_test_video_codec(path, w, h, n_frames, fps, 8, "mpeg4");
}

}  // extern "C"
