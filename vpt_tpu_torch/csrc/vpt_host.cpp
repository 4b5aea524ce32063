// vpt_host — native host-side data plane of vpt_tpu_torch (the port's own copy
// of the JAX package's host library).
//
// Provides the performance-critical host operations the reference delegates to
// OpenCV/FFmpeg C++ through Python wrappers (reference: data_loader.py uses
// cv2.VideoCapture / cv2.resize / alpha compositing; run_inverse_dynamics_model.py
// decodes 640x360 mp4s):
//
//   * mp4/mkv video decode (libavformat + libavcodec + libswscale → RGB24)
//   * video encode (for synthetic test fixtures and visualization output)
//   * cv2-bit-exact INTER_LINEAR uint8 resize (11-bit fixed point)
//   * alpha compositing of the mouse-cursor sprite
//
// Exposed as a C ABI consumed via ctypes (vpt_tpu_torch/data/video.py), which
// compiles it with g++ against pkg-config's libav at first use.
//
// The decoder is single-stream; the Python loader runs one instance per worker
// process (matching the reference's one-trajectory-per-worker layout).

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cstdlib>
#include <algorithm>

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libavutil/opt.h>
#include <libavutil/log.h>
#include <libswscale/swscale.h>
}

// Quiet libav's per-encode stderr chatter (callers see real errors via
// return codes); VPT_AV_VERBOSE=1 restores it for debugging.
__attribute__((constructor)) static void vpt_host_init() {
    if (!getenv("VPT_AV_VERBOSE")) av_log_set_level(AV_LOG_ERROR);
}

// ---------------------------------------------------------------------------
// Video decode
// ---------------------------------------------------------------------------

struct VptVideoReader {
    AVFormatContext* fmt = nullptr;
    AVCodecContext* codec = nullptr;
    SwsContext* sws = nullptr;
    AVFrame* frame = nullptr;
    AVFrame* rgb = nullptr;
    AVPacket* pkt = nullptr;
    int stream_index = -1;
    int out_w = 0, out_h = 0;
    bool eof_sent = false;
    uint8_t* scratch = nullptr;  // native-res RGB frame for the batch path
};

extern "C" {

void* vpt_video_open(const char* path) {
    auto* r = new VptVideoReader();
    if (avformat_open_input(&r->fmt, path, nullptr, nullptr) < 0) {
        delete r;
        return nullptr;
    }
    if (avformat_find_stream_info(r->fmt, nullptr) < 0) {
        avformat_close_input(&r->fmt);
        delete r;
        return nullptr;
    }
    const AVCodec* dec = nullptr;
    r->stream_index = av_find_best_stream(r->fmt, AVMEDIA_TYPE_VIDEO, -1, -1, &dec, 0);
    if (r->stream_index < 0 || !dec) {
        avformat_close_input(&r->fmt);
        delete r;
        return nullptr;
    }
    r->codec = avcodec_alloc_context3(dec);
    avcodec_parameters_to_context(r->codec, r->fmt->streams[r->stream_index]->codecpar);
    r->codec->thread_count = 0;  // auto
    if (avcodec_open2(r->codec, dec, nullptr) < 0) {
        avcodec_free_context(&r->codec);
        avformat_close_input(&r->fmt);
        delete r;
        return nullptr;
    }
    r->frame = av_frame_alloc();
    r->rgb = av_frame_alloc();
    r->pkt = av_packet_alloc();
    return r;
}

int vpt_video_info(void* handle, int* width, int* height, double* fps, int64_t* nframes) {
    auto* r = static_cast<VptVideoReader*>(handle);
    if (!r) return 0;
    *width = r->codec->width;
    *height = r->codec->height;
    AVStream* st = r->fmt->streams[r->stream_index];
    *fps = st->avg_frame_rate.den ? av_q2d(st->avg_frame_rate) : 0.0;
    *nframes = st->nb_frames;  // may be 0 when the container doesn't record it
    return 1;
}

// Decode the next frame into out_rgb (H*W*3, RGB24 at native resolution).
// Returns 1 on success, 0 on EOF, -1 on error.
int vpt_video_read(void* handle, uint8_t* out_rgb) {
    auto* r = static_cast<VptVideoReader*>(handle);
    if (!r) return -1;
    const int w = r->codec->width, h = r->codec->height;
    while (true) {
        int ret = avcodec_receive_frame(r->codec, r->frame);
        if (ret == 0) {
            if (!r->sws) {
                r->sws = sws_getContext(w, h, r->codec->pix_fmt, w, h, AV_PIX_FMT_RGB24,
                                        SWS_BILINEAR, nullptr, nullptr, nullptr);
            }
            uint8_t* dst[1] = {out_rgb};
            int dst_stride[1] = {3 * w};
            sws_scale(r->sws, r->frame->data, r->frame->linesize, 0, h, dst, dst_stride);
            av_frame_unref(r->frame);
            return 1;
        }
        if (ret == AVERROR_EOF) return 0;
        if (ret != AVERROR(EAGAIN)) return -1;
        // feed more packets
        while (true) {
            ret = av_read_frame(r->fmt, r->pkt);
            if (ret < 0) {
                if (!r->eof_sent) {
                    avcodec_send_packet(r->codec, nullptr);  // flush
                    r->eof_sent = true;
                }
                break;
            }
            if (r->pkt->stream_index == r->stream_index) {
                ret = avcodec_send_packet(r->codec, r->pkt);
                av_packet_unref(r->pkt);
                if (ret < 0 && ret != AVERROR(EAGAIN)) return -1;
                break;
            }
            av_packet_unref(r->pkt);
        }
    }
}

void vpt_video_close(void* handle) {
    auto* r = static_cast<VptVideoReader*>(handle);
    if (!r) return;
    if (r->scratch) delete[] r->scratch;
    if (r->sws) sws_freeContext(r->sws);
    if (r->pkt) av_packet_free(&r->pkt);
    if (r->frame) av_frame_free(&r->frame);
    if (r->rgb) av_frame_free(&r->rgb);
    if (r->codec) avcodec_free_context(&r->codec);
    if (r->fmt) avformat_close_input(&r->fmt);
    delete r;
}

// ---------------------------------------------------------------------------
// Video encode (test fixtures / visualization)
// ---------------------------------------------------------------------------

struct VptVideoWriter {
    AVFormatContext* fmt = nullptr;
    AVCodecContext* codec = nullptr;
    AVStream* stream = nullptr;
    SwsContext* sws = nullptr;
    AVFrame* yuv = nullptr;
    AVPacket* pkt = nullptr;
    int w = 0, h = 0;
    int64_t next_pts = 0;
};

static int vpt_writer_flush(VptVideoWriter* w, bool final_flush) {
    int ret = avcodec_send_frame(w->codec, final_flush ? nullptr : w->yuv);
    if (ret < 0) return -1;
    while (true) {
        ret = avcodec_receive_packet(w->codec, w->pkt);
        if (ret == AVERROR(EAGAIN) || ret == AVERROR_EOF) return 0;
        if (ret < 0) return -1;
        if (w->pkt->duration == 0) w->pkt->duration = 1;  // 1 tick in codec tb;
        // without it the mp4 muxer under-counts track duration and the demuxer
        // edit-list marks the last sample AV_PKT_FLAG_DISCARD
        av_packet_rescale_ts(w->pkt, w->codec->time_base, w->stream->time_base);
        w->pkt->stream_index = w->stream->index;
        if (av_interleaved_write_frame(w->fmt, w->pkt) < 0) return -1;
    }
}

void* vpt_video_writer_open(const char* path, int width, int height, int fps) {
    auto* w = new VptVideoWriter();
    w->w = width;
    w->h = height;
    if (avformat_alloc_output_context2(&w->fmt, nullptr, nullptr, path) < 0 || !w->fmt) {
        delete w;
        return nullptr;
    }
    // Prefer h264 when the build carries an encoder; fall back to mpeg4
    const AVCodec* enc = avcodec_find_encoder_by_name("libx264");
    if (!enc) enc = avcodec_find_encoder(AV_CODEC_ID_MPEG4);
    if (!enc) {
        avformat_free_context(w->fmt);
        delete w;
        return nullptr;
    }
    w->stream = avformat_new_stream(w->fmt, nullptr);
    w->codec = avcodec_alloc_context3(enc);
    w->codec->width = width;
    w->codec->height = height;
    w->codec->time_base = {1, fps};
    w->stream->time_base = w->codec->time_base;
    w->codec->framerate = {fps, 1};
    w->codec->pix_fmt = AV_PIX_FMT_YUV420P;
    w->codec->gop_size = 12;
    w->codec->bit_rate = (int64_t)width * height * 8;
    if (w->fmt->oformat->flags & AVFMT_GLOBALHEADER)
        w->codec->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
    if (enc->id == AV_CODEC_ID_H264)
        av_opt_set(w->codec->priv_data, "preset", "veryfast", 0);
    if (avcodec_open2(w->codec, enc, nullptr) < 0 ||
        avcodec_parameters_from_context(w->stream->codecpar, w->codec) < 0 ||
        avio_open(&w->fmt->pb, path, AVIO_FLAG_WRITE) < 0 ||
        avformat_write_header(w->fmt, nullptr) < 0) {
        avcodec_free_context(&w->codec);
        avformat_free_context(w->fmt);
        delete w;
        return nullptr;
    }
    w->yuv = av_frame_alloc();
    w->yuv->format = AV_PIX_FMT_YUV420P;
    w->yuv->width = width;
    w->yuv->height = height;
    av_frame_get_buffer(w->yuv, 0);
    w->pkt = av_packet_alloc();
    w->sws = sws_getContext(width, height, AV_PIX_FMT_RGB24, width, height,
                            AV_PIX_FMT_YUV420P, SWS_BILINEAR, nullptr, nullptr, nullptr);
    return w;
}

int vpt_video_writer_write(void* handle, const uint8_t* rgb) {
    auto* w = static_cast<VptVideoWriter*>(handle);
    if (!w) return -1;
    av_frame_make_writable(w->yuv);
    const uint8_t* src[1] = {rgb};
    int src_stride[1] = {3 * w->w};
    sws_scale(w->sws, src, src_stride, 0, w->h, w->yuv->data, w->yuv->linesize);
    w->yuv->pts = w->next_pts++;
    return vpt_writer_flush(w, false);
}

int vpt_video_writer_close(void* handle) {
    auto* w = static_cast<VptVideoWriter*>(handle);
    if (!w) return -1;
    vpt_writer_flush(w, true);
    av_write_trailer(w->fmt);
    avio_closep(&w->fmt->pb);
    sws_freeContext(w->sws);
    av_packet_free(&w->pkt);
    av_frame_free(&w->yuv);
    avcodec_free_context(&w->codec);
    avformat_free_context(w->fmt);
    delete w;
    return 0;
}

// ---------------------------------------------------------------------------
// cv2-bit-exact INTER_LINEAR uint8 resize (see vpt_tpu/ops/resize.py for the
// algorithm contract; this is the decoder-hot-path twin of the numpy version)
// ---------------------------------------------------------------------------

static void linear_coeffs(int src, int dst, int* sx, int* a0, int* a1) {
    // cv2's exact quantization: float32 fractional offsets, UNCLAMPED at the
    // borders (callers clamp gather indices instead — border replicate), and
    // coefficients rounded half-to-even to 11 fractional bits.  See
    // vpt_tpu/ops/resize.py for the full contract; cv2-oracle fuzz-tested.
    const double scale = (double)src / dst;
    for (int x = 0; x < dst; ++x) {
        float fx = (float)((x + 0.5) * scale - 0.5);
        int s = (int)std::floor(fx);
        fx -= (float)s;
        sx[x] = s;
        a0[x] = (int)std::nearbyintf((1.0f - fx) * 2048.0f);
        a1[x] = (int)std::nearbyintf(fx * 2048.0f);
    }
}

// Precomputed coefficient plan: amortizes the per-axis coefficient tables and
// the two horizontal-pass scratch rows over a whole batch of frames.
struct ResizePlan {
    int sh, sw, ch, dh, dw;
    int *sx, *ax0, *ax1, *sy, *by0, *by1;
    int *row0, *row1;
};

static ResizePlan* resize_plan_create(int sh, int sw, int ch, int dh, int dw) {
    auto* p = new ResizePlan{sh, sw, ch, dh, dw,
                             new int[dw], new int[dw], new int[dw],
                             new int[dh], new int[dh], new int[dh],
                             new int[dw * ch], new int[dw * ch]};
    linear_coeffs(sw, dw, p->sx, p->ax0, p->ax1);
    linear_coeffs(sh, dh, p->sy, p->by0, p->by1);
    return p;
}

static void resize_plan_destroy(ResizePlan* p) {
    delete[] p->sx; delete[] p->ax0; delete[] p->ax1;
    delete[] p->sy; delete[] p->by0; delete[] p->by1;
    delete[] p->row0; delete[] p->row1;
    delete p;
}

static void resize_plan_run(ResizePlan* p, const uint8_t* src, uint8_t* dst) {
    const int sh = p->sh, sw = p->sw, ch = p->ch, dh = p->dh, dw = p->dw;
    int prev0 = -1, prev1 = -1;

    auto clampi = [](int v, int hi) { return v < 0 ? 0 : (v > hi ? hi : v); };

    auto hresize = [&](int syi, int* row) {
        const uint8_t* s = src + (size_t)syi * sw * ch;
        for (int x = 0; x < dw; ++x) {
            const uint8_t* p0 = s + (size_t)clampi(p->sx[x], sw - 1) * ch;
            const uint8_t* p1 = s + (size_t)clampi(p->sx[x] + 1, sw - 1) * ch;
            for (int c = 0; c < ch; ++c)
                row[x * ch + c] = p0[c] * p->ax0[x] + p1[c] * p->ax1[x];
        }
    };

    for (int y = 0; y < dh; ++y) {
        const int s0 = clampi(p->sy[y], sh - 1);
        const int s1 = clampi(p->sy[y] + 1, sh - 1);
        if (prev0 != s0) { hresize(s0, p->row0); prev0 = s0; }
        if (prev1 != s1) { hresize(s1, p->row1); prev1 = s1; }
        uint8_t* d = dst + (size_t)y * dw * ch;
        const int b0 = p->by0[y], b1 = p->by1[y];
        for (int i = 0; i < dw * ch; ++i) {
            int v = ((b0 * (p->row0[i] >> 4)) >> 16) + (((b1 * (p->row1[i] >> 4)) >> 16) + 2);
            d[i] = (uint8_t)(v >> 2);
        }
    }
}

void vpt_resize_u8(const uint8_t* src, int sh, int sw, int ch, uint8_t* dst, int dh, int dw) {
    ResizePlan* p = resize_plan_create(sh, sw, ch, dh, dw);
    resize_plan_run(p, src, dst);
    resize_plan_destroy(p);
}

// ---------------------------------------------------------------------------
// Cursor alpha compositing (reference: data_loader.py:34-45)
// ---------------------------------------------------------------------------

void vpt_composite_alpha(uint8_t* img, int ih, int iw,
                         const uint8_t* overlay, const uint8_t* alpha,
                         int oh, int ow, int x, int y) {
    const int chh = std::max(0, std::min(ih - y, oh));
    const int cw = std::max(0, std::min(iw - x, ow));
    if (chh == 0 || cw == 0) return;
    for (int r = 0; r < chh; ++r) {
        if (y + r < 0) continue;
        uint8_t* drow = img + ((size_t)(y + r) * iw + x) * 3;
        const uint8_t* orow = overlay + (size_t)r * ow * 3;
        const uint8_t* arow = alpha + (size_t)r * ow;
        for (int cc = 0; cc < cw; ++cc) {
            if (x + cc < 0) continue;
            const double a = arow[cc] / 255.0;
            for (int k = 0; k < 3; ++k) {
                const double blended = drow[cc * 3 + k] * (1.0 - a) + orow[cc * 3 + k] * a;
                drow[cc * 3 + k] = (uint8_t)blended;  // trunc, matching the
                // reference's astype(np.uint8) cast (data_loader.py:45)
            }
        }
    }
}

// ---------------------------------------------------------------------------
// Batched decode + composite + resize — the data-loader fast path.
//
// One C call replaces n (decode, composite, resize) Python round-trips: the
// resize coefficient plan and the native-resolution scratch frame are built
// once per call, and skipped frames (null actions / resume fast-forward) are
// decoded but never composited/resized.  (Reference equivalent: the per-frame
// cv2 pipeline in data_loader.py:104-120.)
// ---------------------------------------------------------------------------

// Decode up to n frames.  Per frame i:
//   * emit[i]==0 → decode only (keeps video/jsonl in step), out slot untouched;
//   * cursor_xy[2i] != INT32_MIN → alpha-composite the (coh, cow) cursor
//     sprite at that position first (recorded mouse position, GUI open);
//   * resize natively to (dh, dw) into out[i*dh*dw*3].
// emit/cursor_xy may be NULL (all emitted / no cursor).  Returns the number of
// frames decoded (< n means EOF), or -1 on decode error.
int vpt_video_read_batch(void* handle, int n,
                         const uint8_t* emit,
                         const int32_t* cursor_xy,
                         const uint8_t* cursor_rgb, const uint8_t* cursor_alpha,
                         int coh, int cow,
                         int dh, int dw, uint8_t* out) {
    auto* r = static_cast<VptVideoReader*>(handle);
    if (!r) return -1;
    const int w = r->codec->width, h = r->codec->height;
    if (!r->scratch) r->scratch = new uint8_t[(size_t)w * h * 3];
    ResizePlan* plan = resize_plan_create(h, w, 3, dh, dw);
    int done = 0;
    for (; done < n; ++done) {
        int ret = vpt_video_read(handle, r->scratch);
        if (ret == 0) break;            // EOF
        if (ret < 0) { resize_plan_destroy(plan); return -1; }
        if (emit && !emit[done]) continue;
        if (cursor_xy && cursor_xy[2 * done] != INT32_MIN) {
            vpt_composite_alpha(r->scratch, h, w, cursor_rgb, cursor_alpha,
                                coh, cow, cursor_xy[2 * done], cursor_xy[2 * done + 1]);
        }
        resize_plan_run(plan, r->scratch, out + (size_t)done * dh * dw * 3);
    }
    resize_plan_destroy(plan);
    return done;
}

}  // extern "C"
